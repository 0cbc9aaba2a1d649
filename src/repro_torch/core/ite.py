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
backed by ``jax.random`` draws the reference's sketches.  Not ported yet:
the runtime guard (``guard=``) and checkpoint/resume (``checkpoint_dir=``),
ROADMAP PEPS item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import full_update as _fu
from repro_torch.core import gates as G
from repro_torch.core import planner
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
    # the reference's runtime-guard report and resume step; the port has
    # neither yet (ROADMAP PEPS item 7), so both stay None
    guard: Optional[object] = None
    resumed_from: Optional[int] = None


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
) -> ITEResult:
    """Run TEBD imaginary time evolution on a PEPS.

    ``update`` selects the two-site truncation: :class:`QRUpdate`,
    :class:`DirectUpdate` or :class:`FullUpdate` (row environments cached
    and refreshed every ``update.env_refresh_every`` gate applications).
    The energy is measured with ``contract`` every ``measure_every`` steps
    and after the last.  ``guard`` and ``checkpoint_dir`` raise
    ``NotImplementedError`` until ROADMAP PEPS item 7 ports them."""
    if guard not in (None, False) or checkpoint_dir is not None:
        raise NotImplementedError(
            "the runtime guard and checkpoint/resume of ite_run are not "
            "ported yet (ROADMAP PEPS item 7, robustness)")
    check_update(update)
    key = key_or_default(key, DEFAULT_ITE_KEY_SEED)
    moments = trotter_moments(obs, tau)
    energies, measured_at = [], []
    planner_before = planner.stats()

    is_full = isinstance(update, FullUpdate)
    fidelities: Optional[List[float]] = [] if is_full else None
    envs, since_refresh = None, 0
    if is_full:
        _fu.drain_fidelities()  # start the log window fresh

    for step in range(steps):
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
    return ITEResult(state, energies, measured_at,
                     planner.stats_since(planner_before), fidelities)


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
