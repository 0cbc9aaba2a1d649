"""Imaginary time evolution (paper Sections II-D1, VI-D1).

Counterpart of ``repro.core.ite``.  TEBD with first-order Trotter-Suzuki:
one ITE step applies ``exp(-tau * c_i * H_i)`` for every local term of the
Hamiltonian with a truncating two-site update — ``QRUpdate`` (simple
update), ``DirectUpdate`` or ``FullUpdate`` (environment-aware).
Next-nearest-neighbour terms are routed with SWAP chains by
``apply_operator``.

With ``FullUpdate`` the loop keeps cached top/bottom row environments and
refreshes them every ``update.env_refresh_every`` gate applications, or
when a bond has grown since the sweep; the per-bond truncation fidelities
are aggregated into the result.  The Rayleigh quotient
<psi|H|psi>/<psi|psi> over cached environments tracks convergence.

The loop splits its key exactly where the reference does, so a key object
backed by ``jax.random`` draws the reference's sketches.

Robustness (``docs/robustness.md`` describes the reference's contract):

* ``checkpoint_dir=``/``checkpoint_every=`` snapshot the complete loop
  state — site tensors, ``log_scale``, the key's state, the energy trace,
  the cached row environments and refresh counter, the undrained fidelity
  window — through :class:`repro_torch.checkpoint.CheckpointManager`, with
  the reference's leaf names.  A run called again with the same arguments
  resumes from the latest checkpoint and reproduces the uninterrupted
  run's energies bit for bit: the environments and the refresh counter
  are in the snapshot so that the key stream is split at the same places.
* ``guard=`` activates the runtime guard
  (:mod:`repro_torch.core.runtime_guard`) over the run; its report lands
  in ``ITEResult.guard``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import full_update as _fu
from repro_torch.core import gates as G
from repro_torch.core import planner, runtime_guard
from repro_torch.core import statevector as sv
from repro_torch.core.bmps import BMPS
from repro_torch.core.environments import row_environments
from repro_torch.core.expectation import expectation
from repro_torch.core.keys import key_or_default
from repro_torch.core.observable import Observable
from repro_torch.core.peps import FullUpdate, PEPS, apply_operator, \
    check_update, normalize_sites

#: Seed of the key :func:`ite_run` uses when called with ``key=None``.
DEFAULT_ITE_KEY_SEED = 2020


def trotter_moments(obs: Observable, tau: float):
    """One first-order Trotter step: [(gate, sites), ...] for exp(-tau*H)."""
    return [(G.trotter_gate(term.coeff * term.matrix, tau), list(term.sites))
            for term in obs]


def trotter_step(state: PEPS, moments, update, key, envs=None,
                 since_refresh: int = 0):
    """One Trotter step of :func:`ite_run`, without its measurement: each
    gate of ``moments`` with its own key, then ``normalize_sites``.  With
    ``FullUpdate`` the cached row environments ``envs`` are refreshed after
    ``update.env_refresh_every`` gate applications (``since_refresh``
    counts them), or when a bond has outgrown them.  Returns ``(state,
    key, envs, since_refresh)`` for the next step."""
    is_full = isinstance(update, FullUpdate)
    for g, sites in moments:
        key, sub = key.split(2)
        if is_full and len(sites) == 2:
            s0, s1 = state.coords(sites[0]), state.coords(sites[1])
            if (envs is None
                    or since_refresh >= update.env_refresh_every
                    or not _fu.envs_compatible(state, s0, s1, envs)):
                key, ek = key.split(2)
                envs = row_environments(state, _fu.env_option(update), ek)
                since_refresh = 0
        state = apply_operator(state, g, sites, update, key=sub, envs=envs)
        since_refresh += 1
    # environments survive normalize_sites (the positive-fixed metric is
    # invariant under uniform rescales) and step boundaries
    return normalize_sites(state), key, envs, since_refresh


@dataclasses.dataclass
class ITEResult:
    state: PEPS
    energies: List[float]
    steps: List[int]
    # planner cache counters over the run (path/fused hit rates): the loop
    # re-applies the same Trotter moments every step, so after the bonds
    # stop growing every path and fused lookup is a hit
    planner_stats: Optional[dict] = None
    # FullUpdate only: per measurement point, the minimum bond truncation
    # fidelity since the previous one; None for QRUpdate/DirectUpdate
    fidelities: Optional[List[float]] = None
    # the runtime-guard report of a guard= run, else None
    guard: Optional[runtime_guard.GuardReport] = None
    # the checkpoint step this run resumed from, or None for a fresh run
    resumed_from: Optional[int] = None


# ---------------------------------------------------------------------------
# Checkpoint encode/decode (flat {path: array} trees, the reference's leaves)
# ---------------------------------------------------------------------------

def _ite_snapshot(state: PEPS, key, energies, measured_at, fidelities,
                  fid_window, since_refresh, envs, planner_delta,
                  next_step: int) -> dict:
    """The complete loop state as one flat checkpointable tree."""
    tree = {f"sites/{i}_{j}": state.sites[i][j]
            for i in range(state.nrow) for j in range(state.ncol)}
    log_scale = state.log_scale
    tree["log_scale"] = (log_scale if isinstance(log_scale, torch.Tensor)
                         else np.asarray(log_scale, dtype=np.float64))
    tree["key"] = key.state()
    tree["energies"] = np.asarray(energies, dtype=np.float64)
    tree["measured_at"] = np.asarray(measured_at, dtype=np.int64)
    tree["since_refresh"] = np.asarray(since_refresh, dtype=np.int64)
    if fidelities is not None:
        tree["fidelities"] = np.asarray(fidelities, dtype=np.float64)
        tree["fid_window"] = np.asarray(fid_window, dtype=np.float64)
    if envs is not None:
        for name, levels in zip(("envs_top", "envs_bot"), envs):
            for lvl, mps in enumerate(levels):
                for c, t in enumerate(mps):
                    tree[f"{name}/{lvl}/{c}"] = t
    meta = {"next_step": next_step, "planner_delta": planner_delta}
    tree["meta_json"] = np.array(json.dumps(meta))
    return tree


def _decode_env_levels(flat: dict, prefix: str, device):
    levels: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        _, lvl, c = k.split("/")
        levels.setdefault(int(lvl), {})[int(c)] = \
            torch.from_numpy(v).to(device)
    return [[levels[l][c] for c in sorted(levels[l])]
            for l in sorted(levels)] or None


def _ite_restore(flat: dict, nrow: int, ncol: int, key_type, device):
    """Invert :func:`_ite_snapshot` -> (state, key, loop-state dict), the
    tensors on ``device`` and the key rebuilt as ``key_type``."""
    sites = [[torch.from_numpy(flat[f"sites/{i}_{j}"]).to(device)
              for j in range(ncol)] for i in range(nrow)]
    state = PEPS(sites, torch.from_numpy(flat["log_scale"]).to(device))
    key = key_type.from_state(flat["key"])
    meta = json.loads(str(flat["meta_json"][()]))
    top = _decode_env_levels(flat, "envs_top/", device)
    bot = _decode_env_levels(flat, "envs_bot/", device)
    return state, key, {
        "energies": [float(e) for e in flat["energies"]],
        "measured_at": [int(s) for s in flat["measured_at"]],
        "fidelities": ([float(f) for f in flat["fidelities"]]
                       if "fidelities" in flat else None),
        "fid_window": ([float(f) for f in flat["fid_window"]]
                       if "fid_window" in flat else []),
        "since_refresh": int(flat["since_refresh"]),
        "envs": (top, bot) if top is not None else None,
        "next_step": int(meta["next_step"]),
        "planner_delta": meta.get("planner_delta") or {},
    }


def _merge_planner_stats(prior: dict, current: dict) -> dict:
    """Whole-logical-run counters: sum the deltas, keep current cache sizes."""
    out = dict(current)
    for k, v in prior.items():
        if k.endswith("_cache_size"):
            continue
        out[k] = out.get(k, 0) + v
    return out


def ite_run(
    state: PEPS,
    obs: Observable,
    tau: float,
    steps: int,
    update,
    contract: BMPS,
    measure_every: int = 10,
    key=None,
    callback: Optional[Callable] = None,
    *,
    guard=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 3,
    resume: bool = True,
) -> ITEResult:
    """Run TEBD imaginary time evolution on a PEPS.

    ``update`` selects the two-site truncation: :class:`QRUpdate`,
    :class:`DirectUpdate` or :class:`FullUpdate` (row environments cached
    and refreshed every ``update.env_refresh_every`` gate applications).
    The energy is measured with ``contract`` every ``measure_every`` steps
    and after the last.

    ``guard`` activates the runtime guard for the whole run (``True`` for
    defaults, a :class:`~repro_torch.core.runtime_guard.GuardConfig` or a
    ``RuntimeGuard``).  ``checkpoint_dir`` + ``checkpoint_every=N``
    snapshot the loop state every N steps (async, atomic); with
    ``resume=True`` a call resumes from the latest checkpoint in the
    directory, its tensors on ``state``'s device and its key rebuilt with
    ``type(key).from_state`` (``TorchKey`` when ``key`` is None).
    ``checkpoint_keep`` is how many checkpoints are kept."""
    check_update(update)
    key = key_or_default(key, DEFAULT_ITE_KEY_SEED)
    moments = trotter_moments(obs, tau)
    energies, measured_at = [], []
    planner_before = planner.stats()
    prior_planner_delta: dict = {}

    is_full = isinstance(update, FullUpdate)
    fidelities: Optional[List[float]] = [] if is_full else None
    envs, since_refresh = None, 0
    if is_full:
        _fu.drain_fidelities()  # start the log window fresh

    manager = None
    start_step = 0
    resumed_from = None
    if checkpoint_dir is not None:
        manager = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
        latest = manager.latest_step() if resume else None
        if latest is not None:
            device = state.device
            state, key, loop = _ite_restore(manager.load(latest), state.nrow,
                                            state.ncol, type(key), device)
            energies, measured_at = loop["energies"], loop["measured_at"]
            since_refresh = loop["since_refresh"]
            envs = loop["envs"]
            start_step = loop["next_step"]
            prior_planner_delta = loop["planner_delta"]
            resumed_from = latest
            if is_full:
                fidelities = loop["fidelities"] or []
                _fu.restore_fidelities(loop["fid_window"], device)

    active_guard = runtime_guard.resolve(guard)
    with runtime_guard.maybe(active_guard):
        for step in range(start_step, steps):
            state, key, envs, since_refresh = trotter_step(
                state, moments, update, key, envs, since_refresh)
            if (step + 1) % measure_every == 0 or step == steps - 1:
                key, sub = key.split(2)
                e = float(expectation(state, obs, contract, use_cache=True,
                                      key=sub).real)
                energies.append(e)
                measured_at.append(step + 1)
                if is_full:
                    window = _fu.drain_fidelities()
                    fidelities.append(min(window) if window else float("nan"))
                if callback is not None:
                    callback(step + 1, e, state)
            if manager is not None and checkpoint_every > 0 \
                    and (step + 1) % checkpoint_every == 0:
                manager.save(step + 1, _ite_snapshot(
                    state, key, energies, measured_at, fidelities,
                    _fu.pending_fidelities() if is_full else [],
                    since_refresh, envs,
                    _merge_planner_stats(prior_planner_delta,
                                         planner.stats_since(planner_before)),
                    next_step=step + 1))
    if manager is not None:
        manager.wait()
    return ITEResult(
        state, energies, measured_at,
        _merge_planner_stats(prior_planner_delta,
                             planner.stats_since(planner_before)),
        fidelities,
        guard=active_guard.report if active_guard is not None else None,
        resumed_from=resumed_from)


def ite_statevector(nrow: int, ncol: int, obs: Observable, tau: float,
                    steps: int, dtype=torch.complex128, device=None, *,
                    bits=None) -> Tuple[torch.Tensor, float]:
    """Reference: the same Trotterized ITE on the exact statevector (the
    paper's "state vector simulation after 1000 ITE steps" of Fig. 13),
    from |0...0>, or from the basis state ``bits`` (an ``nrow x ncol``
    array, as :func:`~repro_torch.core.peps.computational_basis` takes)."""
    if bits is None:
        bits = np.zeros((nrow, ncol), dtype=int)
    vec = sv.basis(np.ravel(bits), dtype=dtype, device=device)
    moments = trotter_moments(obs, tau)
    for _ in range(steps):
        for g, sites in moments:
            vec = sv.apply_gate(vec, g, sites)
        vec = sv.normalize(vec)
    energy = float(sv.expectation(vec, obs.as_tuples()).real)
    return vec, energy
