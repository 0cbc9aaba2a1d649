"""Variational quantum eigensolver simulation (paper Section VI-D2).

Counterpart of ``repro.core.vqe``.  The ansatz is the paper's: layers of Ry
rotations on every qubit followed by CNOTs on all nearest-neighbour pairs.
Three optimizer families drive the PEPS-simulated energy
``E(theta) = <psi(theta)|H|psi(theta)>``:

* **SLSQP** (the paper's choice, through ``scipy.optimize.minimize``) — one
  energy evaluation at a time;
* **SPSA** — derivative-free; sequential (``ensemble=1``, perturbations
  from ``np.random.default_rng(seed)``, the reference's trajectory) or an
  ensemble (``ensemble=k`` perturbation pairs a step);
* **adam** (``method="adam"``) — gradient descent on the exact autograd
  gradient of the PEPS energy with :mod:`repro_torch.optim.adamw`; always
  an ensemble (``ensemble=1`` is an ensemble of one).

:func:`vqe_energy_peps` builds the energy from torch operations, so
``torch.autograd`` runs through the ansatz gates, every einsumsvd
truncation (the regularized derivatives of :mod:`repro_torch.core.svd_grad`)
and the boundary contraction.  :func:`vqe_energy_and_grad` is that
value-and-grad, its callable cached per network signature in the planner's
fused cache.  The port's kernels have no backward: a differentiated operand
routes dense under ``auto`` and raises under a forced ``kernel`` mode
(:mod:`repro_torch.kernels.dispatch`), so a complex64 gradient runs dense.

The reference ``vmap``s its ensemble members; the port runs them one after
another, each on its device: ``mesh=`` (a
:class:`~repro_torch.launch.mesh.Mesh`) places member ``i`` where
:func:`repro_torch.core.sharding.ensemble_sharding` puts it, the optimizer
state stays on the CPU, and the values equal an unplaced run's.  Member
``i`` draws its initial angles from ``key.fold_in(i)`` and
its SPSA signs at iteration ``k`` from
``key.fold_in(0x5B5A).fold_in(k).fold_in(i)`` (``key`` defaults to
``TorchKey(seed)``), so its trajectory depends only on ``(seed, k, i)``,
never on the ensemble size.  Every energy of a run draws its einsumsvd
sketches from a key of the same type at ``DEFAULT_VQE_KEY_SEED``, so a key
backed by ``jax.random`` replays the reference's members and its
randomized-SVD sketches.  Parameters cross the API as numpy angles.

Robustness, as in the reference (``docs/robustness.md``):
``checkpoint_dir=``/``checkpoint_every=`` snapshot the optimizer state
through :class:`repro_torch.checkpoint.CheckpointManager`.  Sequential
SPSA resumes bit for bit (the snapshot carries the numpy Generator state),
the ensembles too (their streams are stateless, so the parameters, moments
and the iteration index suffice), SLSQP as a warm restart.  ``guard=``
activates the runtime guard: host-driven evaluations (SLSQP, sequential
SPSA) guard every einsumsvd solve; gradient evaluations and the ensemble
iterations are guarded as a whole, with the per-solve guard suspended, and
a non-finite result replays them one escalation rung more conservative.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import faults, planner, runtime_guard
from repro_torch.core import statevector as sv
from repro_torch.core.bmps import BMPS
from repro_torch.core.circuits import apply_circuit_peps, \
    apply_circuit_statevector, vqe_ansatz
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
from repro_torch.core.expectation import expectation
from repro_torch.core.keys import TorchKey, key_or_default
from repro_torch.core.observable import Observable
from repro_torch.core.peps import QRUpdate, computational_zeros
from repro_torch.core.precision import PrecisionWrapped
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.optim.adamw import OptConfig, adamw_update

#: Seed of the key the energy functions use when called with ``key=None``
#: (the einsumsvd sketch stream of the circuit application).
DEFAULT_VQE_KEY_SEED = 77

#: SPSA gain schedule (sequential and ensemble SPSA):
#: a_k = a0/(1+k)^0.602, c_k = c0/(1+k)^0.101 (Spall's standard exponents).
SPSA_GAINS = (0.15, 0.12)

# the reference folds this constant into the seed key for the SPSA signs
_SPSA_STREAM = 0x5B5A


def _angles(thetas, device: torch.device):
    """Torch angles move to ``device`` on their graph; anything else is a
    numpy array of angles (concrete gates)."""
    if isinstance(thetas, torch.Tensor):
        return thetas.to(device)
    return np.asarray(thetas, dtype=np.float64)


def vqe_energy_peps(thetas, nrow: int, ncol: int, obs: Observable,
                    update: QRUpdate, contract: BMPS, key=None, *,
                    dtype=torch.complex128, device=None) -> torch.Tensor:
    """Energy of the ansatz state simulated with PEPS, a real scalar tensor.

    ``thetas`` is a numpy array (concrete gates) or a torch tensor, whose
    autograd graph the energy keeps."""
    device = resolve_device(device)
    key = key_or_default(key, DEFAULT_VQE_KEY_SEED)
    circuit = vqe_ansatz(nrow, ncol, _angles(thetas, device))
    state = computational_zeros(nrow, ncol, dtype=dtype, device=device)
    state = apply_circuit_peps(state, circuit, update, key)
    return expectation(state, obs, contract, use_cache=True).real


def vqe_energy_statevector(thetas, nrow: int, ncol: int, obs: Observable, *,
                           dtype=torch.complex128,
                           device=None) -> torch.Tensor:
    """Exact statevector energy of the ansatz state (the gradient oracle of
    an exact bond budget), differentiable like :func:`vqe_energy_peps`."""
    device = resolve_device(device)
    circuit = vqe_ansatz(nrow, ncol, _angles(thetas, device))
    vec = apply_circuit_statevector(
        sv.zeros(nrow * ncol, dtype=dtype, device=device), circuit)
    return sv.expectation(vec, obs.as_tuples()).real


# ---------------------------------------------------------------------------
# value and gradient
# ---------------------------------------------------------------------------

def _obs_signature(obs: Observable) -> tuple:
    """Hashable identity of an observable for the fused-cache key."""
    return tuple((tuple(t.sites), np.asarray(t.matrix).tobytes(),
                  complex(t.coeff)) for t in obs)


def _grad_signature(nrow: int, ncol: int, n_params: int, obs: Observable,
                    update, contract, dtype, device: torch.device) -> tuple:
    """Everything that changes what a gradient evaluation computes: the
    lattice, the parameter count, the observable, the (frozen-dataclass)
    options, the kernel-dispatch state, the dtype and the device type."""
    return (nrow, ncol, n_params, _obs_signature(obs), repr(update),
            repr(contract), dispatch.backend_signature(), str(dtype),
            device.type)


def _build_value_and_grad(nrow, ncol, obs, update, contract, dtype):
    def run(thetas: torch.Tensor, key):
        th = thetas.detach().requires_grad_(True)
        with torch.enable_grad():
            e = vqe_energy_peps(th, nrow, ncol, obs, update, contract, key,
                                dtype=dtype, device=th.device)
            (g,) = torch.autograd.grad(e, th)
        return e.detach().to(torch.float64), g
    return run


# ---------------------------------------------------------------------------
# The runtime guard at evaluation granularity
# ---------------------------------------------------------------------------

def _all_finite(tree) -> bool:
    """Are all entries of a tree of tensors, arrays and floats finite?  One
    device-to-host read for the tensors."""
    leaves = list(tree.values()) if isinstance(tree, dict) else (
        list(tree) if isinstance(tree, (list, tuple)) else [tree])
    flags = []
    for leaf in leaves:
        if isinstance(leaf, (dict, list, tuple)):
            if not _all_finite(leaf):
                return False
        elif isinstance(leaf, torch.Tensor):
            flags.append(torch.isfinite(leaf.detach()).all())
        elif not np.all(np.isfinite(np.asarray(leaf))):
            return False
    if not flags:
        return True
    return bool(torch.stack([f.to(flags[0].device) for f in flags]).all())


def _grad_ladder(update: QRUpdate, contract: BMPS):
    """Evaluation-granularity escalation rungs ``(rung, update, contract,
    force_dense)``, cumulative: the mirror of
    :func:`repro_torch.core.runtime_guard._ladder` for a whole evaluation,
    which swaps the options of every solve at once."""
    def base(opt):
        return opt.inner if isinstance(opt, PrecisionWrapped) else opt

    rungs = []
    upd, con = update, contract
    u_base, c_base = base(upd.svd), base(con.svd)
    if isinstance(u_base, RandomizedSVD) or isinstance(c_base, RandomizedSVD):
        def to_direct(b):
            return DirectSVD(cutoff=getattr(b, "cutoff", 0.0)) \
                if isinstance(b, RandomizedSVD) else b
        upd = dataclasses.replace(
            upd, svd=(PrecisionWrapped(to_direct(u_base), upd.svd.policy)
                      if isinstance(upd.svd, PrecisionWrapped)
                      else to_direct(u_base)))
        con = dataclasses.replace(con, svd=to_direct(c_base))
        rungs.append(("exact_svd", upd, con, False))
    if isinstance(upd.svd, PrecisionWrapped) or \
            isinstance(con.svd, PrecisionWrapped):
        upd = dataclasses.replace(upd, svd=base(upd.svd))
        con = dataclasses.replace(con, svd=base(con.svd), precision="exact")
        rungs.append(("exact_precision", upd, con, False))
    rungs.append(("dense_kernel", upd, con, True))
    return rungs


def _escalate(run: Callable, active_guard, update: QRUpdate, contract: BMPS,
              site: str = "vqe_grad"):
    """Run ``run(update, contract, force_dense)`` under the evaluation-level
    guard: its output when finite (or unguarded), else the ladder's rungs
    in turn, with the per-solve guard's counters, report and exhaustion.
    A ``torch.linalg.LinAlgError`` counts as a non-finite output: torch's
    factorizations raise on the NaN that the reference's return."""
    if active_guard is None:
        return run(update, contract, False)

    def finite_or_none(upd, con, force_dense):
        try:
            out = run(upd, con, force_dense)
        except torch.linalg.LinAlgError:
            return None
        return out if _all_finite(out) else None

    out = finite_or_none(update, contract, False)
    if out is not None:
        return out
    config, report = active_guard.config, active_guard.report
    report.tick("guard_nan_events")
    report.record(runtime_guard.GuardEvent(site, "nan", 0, "detected"))
    attempts = 0
    for rung, upd, con, force_dense in \
            _grad_ladder(update, contract)[:config.max_retries]:
        attempts += 1
        report.tick("guard_retries")
        report.tick(f"guard_rung_{rung}")
        report.record(runtime_guard.GuardEvent(site, "nan", attempts,
                                               f"retry:{rung}"))
        out = finite_or_none(upd, con, force_dense)
        if out is not None:
            report.tick("guard_recovered")
            report.record(runtime_guard.GuardEvent(site, "nan", attempts,
                                                   f"recovered:{rung}"))
            return out
    report.tick("guard_exhausted")
    report.record(runtime_guard.GuardEvent(site, "nan", attempts,
                                           "exhausted"))
    raise runtime_guard.GuardExhaustedError(site, "nan", attempts,
                                            list(report.events))


@contextlib.contextmanager
def _evaluation(force_dense: bool):
    """One evaluation of the evaluation-level guard: the per-solve stack
    suspended, every kernel site dense when ``force_dense``."""
    with runtime_guard.suspended():
        with dispatch.forced_dense() if force_dense \
                else contextlib.nullcontext():
            yield


def vqe_energy_and_grad(thetas, nrow: int, ncol: int, obs: Observable,
                        update: QRUpdate, contract: BMPS, key=None, *,
                        guard=None, dtype=torch.complex128, device=None):
    """``(E(theta), dE/dtheta)`` of the PEPS energy, float64 tensors on the
    device, by ``torch.autograd.grad``.  Eager torch has no program to
    reuse; the callable goes through the planner's fused cache per network
    signature only so that ``planner.stats()`` (and ``VQEResult.
    planner_stats``) count a value-and-grad's fused hits and misses as the
    reference counts its compiled ``value_and_grad``.

    With a guard (``guard=`` or an active ``RuntimeGuard``) or a fault
    armed, the evaluation runs with the per-solve guard suspended and is
    guarded as a whole: a non-finite energy or gradient replays it one
    ladder rung more conservative (exact SVD -> exact precision -> dense
    kernels), as the reference does."""
    device = resolve_device(device)
    key = key_or_default(key, DEFAULT_VQE_KEY_SEED)
    if isinstance(thetas, torch.Tensor):
        th = thetas.detach().to(device=device, dtype=torch.float64)
    else:
        th = torch.as_tensor(np.asarray(thetas, dtype=np.float64),
                             device=device)
    active = runtime_guard.resolve(guard) or runtime_guard.current()
    if active is None and not faults.active():
        sig = _grad_signature(nrow, ncol, int(th.shape[0]), obs, update,
                              contract, dtype, device)
        fn = planner.fused_fn(
            "vqe_grad", sig,
            lambda: _build_value_and_grad(nrow, ncol, obs, update, contract,
                                          dtype))
        return fn(th, key)

    def run(upd, con, force_dense):
        with _evaluation(force_dense):
            return _build_value_and_grad(nrow, ncol, obs, upd, con,
                                         dtype)(th, key)
    return _escalate(run, active, update, contract)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VQEResult:
    thetas: np.ndarray
    energy: float
    history: List[float]
    n_evals: int
    # planner cache counters over the run (for a resumed run summed with
    # the checkpointed counters of the earlier process: the whole run)
    planner_stats: Optional[dict] = None
    # the runtime-guard report of a guard= run, else None
    guard: Optional[runtime_guard.GuardReport] = None
    # the checkpoint step this run resumed from, or None for a fresh run
    resumed_from: Optional[int] = None
    # ensemble runs only (method="adam" or SPSA with ensemble>1): final
    # parameters (ensemble, P), final energies (ensemble,), and the
    # per-iteration per-member energy trace (iterations, ensemble).
    # ``thetas``/``energy``/``history`` then hold the best member / the
    # per-iteration best.
    ensemble_thetas: Optional[np.ndarray] = None
    ensemble_energies: Optional[np.ndarray] = None
    ensemble_history: Optional[np.ndarray] = None


def _vqe_snapshot(x: np.ndarray, k: int, history: List[float],
                  rng: Optional[np.random.Generator],
                  planner_delta: dict) -> dict:
    """Snapshot of a sequential run (SPSA, SLSQP); with ``rng`` its whole
    Generator state, so that SPSA's perturbation stream continues exactly."""
    tree = {
        "x": np.asarray(x, dtype=np.float64),
        "k": np.asarray(k, dtype=np.int64),
        "history": np.asarray(history, dtype=np.float64),
        "meta_json": np.array(json.dumps({"planner_delta": planner_delta})),
    }
    if rng is not None:
        tree["rng_state_json"] = np.array(
            json.dumps(rng.bit_generator.state))
    return tree


def _batched_snapshot(state: dict, k: int, ehist: List[np.ndarray],
                      ensemble: int, planner_delta: dict) -> dict:
    """Snapshot of an ensemble run.  No RNG state: the member streams are
    stateless (keys from ``(key, iteration, member)``), so the parameters,
    the adam moments and the iteration index replay the trajectory."""
    hist = (np.asarray(ehist, dtype=np.float64) if ehist
            else np.zeros((0, ensemble), dtype=np.float64))
    return {
        "x": state["x"].to(torch.float64),
        "mu": state["mu"].to(torch.float64),
        "nu": state["nu"].to(torch.float64),
        "count": state["count"].to(torch.int32),
        "k": np.asarray(k, dtype=np.int64),
        "ehist": hist.reshape(len(ehist), ensemble),
        "meta_json": np.array(json.dumps(
            {"planner_delta": planner_delta, "format": "batched-v1"})),
    }


# ---------------------------------------------------------------------------
# The ensemble optimizers (adam / SPSA), one member after another
# ---------------------------------------------------------------------------

def _member_init(key, ensemble: int, n_params: int) -> torch.Tensor:
    """Member ``i``'s initial angles, uniform in [-0.1, 0.1) from
    ``key.fold_in(i)``: independent of the ensemble size.  (ensemble, P)
    float64 on the CPU."""
    return torch.stack([key.fold_in(i).uniform((n_params,), -0.1, 0.1,
                                               torch.float64, "cpu")
                        for i in range(ensemble)])


def _ensemble_step(method, nrow, ncol, obs, update, contract, cfg, key,
                   energy_key, dtype, devices):
    """One iteration of every member as a pure function ``step(state, k,
    update, contract) -> (state, energies)``, member ``i`` on
    ``devices[i]``.  ``state`` is ``{"x", "mu", "nu": (ensemble, P)
    float64, "count": (ensemble,) int32}`` on the CPU (SPSA carries zero
    moments, so both methods share one checkpoint layout); ``energies`` is
    a float64 numpy array of the members'."""
    if method == "adam":
        def member(st, i, k, upd, con):
            e, g = vqe_energy_and_grad(st["x"][i], nrow, ncol, obs, upd, con,
                                       energy_key, dtype=dtype,
                                       device=devices[i])
            mom = {"mu": st["mu"][i], "nu": st["nu"][i],
                   "count": st["count"][i]}
            x, mom, _ = adamw_update(g.cpu(), mom, st["x"][i], cfg)
            return x, mom["mu"], mom["nu"], mom["count"], float(e)
    else:
        a0, c0 = SPSA_GAINS
        spsa_base = key.fold_in(_SPSA_STREAM)

        def member(st, i, k, upd, con):
            def energy(x):
                return float(vqe_energy_peps(x.numpy(), nrow, ncol, obs, upd,
                                             con, energy_key, dtype=dtype,
                                             device=devices[i]))
            x = st["x"][i]
            delta = spsa_base.fold_in(k).fold_in(i).rademacher(
                x.shape, torch.float64, "cpu")
            ak = a0 / (1.0 + k) ** 0.602
            ck = c0 / (1.0 + k) ** 0.101
            gplus = energy(x + ck * delta)
            gminus = energy(x - ck * delta)
            ghat = (gplus - gminus) / (2.0 * ck) * delta
            return (x - ak * ghat, st["mu"][i], st["nu"][i],
                    st["count"][i] + 1, 0.5 * (gplus + gminus))

    def step(st, k, upd, con):
        cols = list(zip(*(member(st, i, k, upd, con)
                          for i in range(st["x"].shape[0]))))
        new = {name: torch.stack(col)
               for name, col in zip(("x", "mu", "nu", "count"), cols)}
        return new, np.asarray(cols[4], dtype=np.float64)
    return step


def _run_ensemble(nrow, ncol, obs, n_layers, maxiter, method, update,
                  contract, ensemble, cfg, key, energy_key, callback, dtype,
                  devices, active_guard, manager, checkpoint_every, resume,
                  current_delta, prior_delta):
    """``maxiter`` adam or SPSA iterations of every member from the
    member-keyed initial angles, one member after another, guarded at
    iteration granularity and checkpointed every ``checkpoint_every``
    iterations.  Returns the final state, the per-iteration energies
    (ensemble,) of every member and the step resumed from."""
    x0 = _member_init(key, ensemble, n_layers * nrow * ncol)
    state = {"x": x0, "mu": torch.zeros_like(x0), "nu": torch.zeros_like(x0),
             "count": torch.zeros((ensemble,), dtype=torch.int32)}
    ehist: List[np.ndarray] = []
    start_k, resumed_from = 0, None
    if manager is not None and resume:
        latest = manager.latest_step()
        if latest is not None:
            flat = manager.load(latest)
            if "ehist" not in flat:
                raise ValueError(
                    f"checkpoint step {latest} is not from a batched VQE "
                    f"run (sequential SPSA/SLSQP snapshot?): pass "
                    f"resume=False or a fresh checkpoint_dir")
            state = {k: torch.from_numpy(flat[k])
                     for k in ("x", "mu", "nu", "count")}
            start_k = int(flat["k"])
            ehist = [np.asarray(row) for row in flat["ehist"]]
            meta = json.loads(str(flat["meta_json"][()]))
            prior_delta.update(meta.get("planner_delta") or {})
            resumed_from = latest

    step = _ensemble_step(method, nrow, ncol, obs, update, contract, cfg,
                          key, energy_key, dtype, devices)
    for k in range(start_k, maxiter):
        def run(upd, con, force_dense, st=state, k=k):
            with _evaluation(force_dense):
                return step(st, k, upd, con)
        if active_guard is None and not faults.active():
            state, e = step(state, k, update, contract)
        else:
            state, e = _escalate(run, active_guard, update, contract)
        ehist.append(e)
        if callback is not None:
            best = int(np.argmin(e))
            callback(len(ehist), float(e[best]), state["x"][best].numpy())
        if manager is not None and checkpoint_every > 0 \
                and (k + 1) % checkpoint_every == 0:
            # saved after iteration k: a resume continues at k + 1
            manager.save(k + 1, _batched_snapshot(state, k + 1, ehist,
                                                  ensemble, current_delta()))
    return state, ehist, resumed_from


# ---------------------------------------------------------------------------
# run_vqe: the public entry point
# ---------------------------------------------------------------------------

def run_vqe(
    nrow: int,
    ncol: int,
    obs: Observable,
    n_layers: int,
    max_bond: int,
    contract_bond: Optional[int] = None,
    maxiter: int = 100,
    seed: int = 0,
    backend: str = "peps",
    method: str = "SLSQP",
    svd: Optional[object] = None,
    *,
    ensemble: int = 1,
    mesh=None,
    lr: float = 0.05,
    guard=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 3,
    resume: bool = True,
    callback: Optional[Callable] = None,
    key=None,
    dtype=torch.complex128,
    device=None,
) -> VQEResult:
    """Minimize the PEPS-simulated (or statevector) energy over the ansatz.

    ``max_bond`` is the PEPS evolution bond dimension, ``contract_bond`` the
    contraction chi (default ``max(2 * max_bond, 4)``), ``svd`` the
    einsumsvd engine of both (default DirectSVD).  ``method``: ``"SLSQP"``
    (or another ``scipy.optimize.minimize`` method), ``"spsa"`` or
    ``"adam"`` (``weight_decay=0``, learning rate ``lr``).  ``ensemble=k``
    (adam, or SPSA with k>1) advances k members, each on its own streams of
    ``key`` (default ``TorchKey(seed)``); the energies' sketches draw from
    ``type(key)(DEFAULT_VQE_KEY_SEED)`` (see the module docstring).
    ``callback(n_evals, energy, x)`` fires after every evaluation (ensemble:
    after every iteration, with the best member).

    ``guard`` activates the runtime guard: SLSQP and sequential SPSA guard
    every einsumsvd solve, the ensemble drivers each iteration as a whole
    (:func:`vqe_energy_and_grad`).  ``checkpoint_dir`` +
    ``checkpoint_every=N`` snapshot the optimizer state every N iterations
    (SLSQP: every N energy evaluations), keeping ``checkpoint_keep``; with
    ``resume=True`` a call resumes from the latest checkpoint: sequential
    SPSA and the ensembles bit for bit, SLSQP as a warm restart from the
    saved angles and history.  ``mesh`` (e.g.
    :func:`repro_torch.launch.mesh.peps_mesh`) places the members of an
    ensemble run (:func:`repro_torch.core.sharding.ensemble_sharding`),
    each member's energies on its device; a ``device`` given beside it
    must be of the mesh's device type."""
    if mesh is None:
        device = resolve_device(device)
        member_devices = [device] * ensemble
    else:
        from repro_torch.core.sharding import ensemble_sharding
        member_devices = ensemble_sharding(mesh, ensemble, 2).devices
        kinds = {d.type for d in member_devices}
        if device is not None:
            kinds.add(torch.device(device).type)
        if len(kinds) != 1:
            raise ValueError(
                f"mesh devices {[str(d) for d in member_devices]} and "
                f"device={device!r} must be of one device type")
        device = member_devices[0]
    # the energies' sketch key, of the caller's key type
    energy_key = (TorchKey if key is None else type(key))(
        DEFAULT_VQE_KEY_SEED)
    n = nrow * ncol
    history: List[float] = []
    planner_before = planner.stats()
    prior_planner_delta: dict = {}
    chi = contract_bond or max(2 * max_bond, 4)
    if svd is None:
        update = QRUpdate(rank=max_bond)
        contract = BMPS(chi)
    else:
        update = QRUpdate(rank=max_bond, svd=svd)
        contract = BMPS(chi, svd=svd)

    method_l = method.lower()
    is_spsa = method_l == "spsa"
    batched = method_l == "adam" or (is_spsa and ensemble > 1)
    if ensemble > 1 and not batched:
        raise ValueError(
            f"ensemble={ensemble} needs a batched driver — method='adam' "
            f"or 'spsa' (got method={method!r})")
    if batched and backend != "peps":
        raise ValueError("batched drivers optimize the PEPS energy "
                         f"(got backend={backend!r})")
    if mesh is not None and not batched:
        raise ValueError(
            f"mesh= places the members of an ensemble run: method='adam', "
            f"or 'spsa' with ensemble > 1 (got method={method!r}, "
            f"ensemble={ensemble})")

    manager = (CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
               if checkpoint_dir is not None else None)
    resumed_from = None

    def current_delta() -> dict:
        out = planner.stats_since(planner_before)
        for pk, pv in prior_planner_delta.items():
            if not pk.endswith("_cache_size"):
                out[pk] = out.get(pk, 0) + pv
        return out

    active_guard = runtime_guard.resolve(guard)

    def finish(x, e) -> VQEResult:
        if manager is not None:
            manager.wait()
        return VQEResult(
            np.asarray(x), float(e), history, len(history),
            planner_stats=current_delta(),
            guard=active_guard.report if active_guard is not None else None,
            resumed_from=resumed_from)

    if batched:
        cfg = OptConfig(lr=lr, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.0, grad_clip=10.0)
        with runtime_guard.maybe(active_guard):
            state, ehist, resumed_from = _run_ensemble(
                nrow, ncol, obs, n_layers, maxiter, method_l, update,
                contract, ensemble, cfg, TorchKey(seed) if key is None
                else key, energy_key, callback, dtype, member_devices,
                active_guard, manager, checkpoint_every, resume,
                current_delta, prior_planner_delta)
            xs = state["x"]

            def run_final(upd, con, force_dense):
                with _evaluation(force_dense):
                    return np.asarray([float(vqe_energy_peps(
                        x.numpy(), nrow, ncol, obs, upd, con, energy_key,
                        dtype=dtype, device=d))
                        for x, d in zip(xs, member_devices)],
                        dtype=np.float64)
            finals = _escalate(run_final, active_guard, update, contract)
        ehist_arr = (np.stack(ehist) if ehist
                     else np.zeros((0, ensemble), dtype=np.float64))
        history.extend(float(r.min()) for r in ehist_arr)
        history.append(float(finals.min()))
        best = int(np.argmin(finals))
        xs = xs.numpy()
        res = finish(xs[best], finals[best])
        res.ensemble_thetas = xs
        res.ensemble_energies = finals
        res.ensemble_history = ehist_arr
        return res

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.1, 0.1, size=n_layers * n)
    start_k = 0
    if manager is not None and resume:
        latest = manager.latest_step()
        if latest is not None:
            flat = manager.load(latest)
            x0 = np.asarray(flat["x"], dtype=np.float64)
            start_k = int(flat["k"])
            history = [float(e) for e in flat["history"]]
            meta = json.loads(str(flat["meta_json"][()]))
            prior_planner_delta.update(meta.get("planner_delta") or {})
            if "rng_state_json" in flat:
                rng.bit_generator.state = json.loads(
                    str(flat["rng_state_json"][()]))
            resumed_from = latest

    def objective(x):
        if backend == "peps":
            e = vqe_energy_peps(x, nrow, ncol, obs, update, contract,
                                energy_key, dtype=dtype, device=device)
        else:
            e = vqe_energy_statevector(x, nrow, ncol, obs, dtype=dtype,
                                       device=device)
        e = float(e)
        history.append(e)
        if callback is not None:
            callback(len(history), e, np.asarray(x))
        return e

    with runtime_guard.maybe(active_guard):
        if is_spsa:
            x = x0.copy()
            a0, c0 = SPSA_GAINS
            for k in range(start_k, maxiter):
                ak = a0 / (1 + k) ** 0.602
                ck = c0 / (1 + k) ** 0.101
                delta = rng.choice([-1.0, 1.0], size=x.shape)
                gplus = objective(x + ck * delta)
                gminus = objective(x - ck * delta)
                ghat = (gplus - gminus) / (2 * ck) * delta
                x = x - ak * ghat
                if manager is not None and checkpoint_every > 0 \
                        and (k + 1) % checkpoint_every == 0:
                    # saved after iteration k, the Generator mid-stream: a
                    # resume continues the perturbations exactly
                    manager.save(k + 1, _vqe_snapshot(
                        x, k + 1, history, rng, current_delta()))
            return finish(x, objective(x))

        from scipy import optimize

        evals_at_save = [len(history)]

        def slsqp_checkpoint(x):
            # scipy owns SLSQP's state, so the snapshot carries (x,
            # history) only: a resume is a warm restart, not a replay
            if checkpoint_every > 0 \
                    and len(history) - evals_at_save[0] >= checkpoint_every:
                evals_at_save[0] = len(history)
                manager.save(len(history), _vqe_snapshot(
                    x, len(history), history, None, current_delta()))

        res = optimize.minimize(
            objective, x0, method=method,
            callback=slsqp_checkpoint if manager is not None else None,
            options={"maxiter": maxiter, "ftol": 1e-9})
        return finish(res.x, float(res.fun))
