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
another.  Member ``i`` draws its initial angles from ``key.fold_in(i)`` and
its SPSA signs at iteration ``k`` from
``key.fold_in(0x5B5A).fold_in(k).fold_in(i)`` (``key`` defaults to
``TorchKey(seed)``), so its trajectory depends only on ``(seed, k, i)``,
never on the ensemble size.  Every energy of a run draws its einsumsvd
sketches from a key of the same type at ``DEFAULT_VQE_KEY_SEED``, so a key
backed by ``jax.random`` replays the reference's members and its
randomized-SVD sketches.  Parameters cross the API as numpy angles.

Not ported yet: the runtime guard (``guard=``) and checkpoint/resume
(``checkpoint_dir=``), ROADMAP PEPS item 7; mesh-sharded ensembles
(``mesh=``), PEPS item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import planner
from repro_torch.core import statevector as sv
from repro_torch.core.bmps import BMPS
from repro_torch.core.circuits import apply_circuit_peps, \
    apply_circuit_statevector, vqe_ansatz
from repro_torch.core.expectation import expectation
from repro_torch.core.keys import TorchKey, key_or_default
from repro_torch.core.observable import Observable
from repro_torch.core.peps import QRUpdate, computational_zeros
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.optim.adamw import OptConfig, adamw_init, adamw_update

#: Seed of the key the energy functions use when called with ``key=None``
#: (the einsumsvd sketch stream of the circuit application).
DEFAULT_VQE_KEY_SEED = 77

#: SPSA gain schedule (sequential and ensemble SPSA):
#: a_k = a0/(1+k)^0.602, c_k = c0/(1+k)^0.101 (Spall's standard exponents).
SPSA_GAINS = (0.15, 0.12)

# the reference folds this constant into the seed key for the SPSA signs
_SPSA_STREAM = 0x5B5A


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} of the VQE optimizers is not "
                               f"ported yet (ROADMAP {item})")


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


def vqe_energy_and_grad(thetas, nrow: int, ncol: int, obs: Observable,
                        update: QRUpdate, contract: BMPS, key=None, *,
                        guard=None, dtype=torch.complex128, device=None):
    """``(E(theta), dE/dtheta)`` of the PEPS energy, float64 tensors on the
    device, by ``torch.autograd.grad``.  Eager torch has no program to
    reuse; the callable goes through the planner's fused cache per network
    signature only so that ``planner.stats()`` (and ``VQEResult.
    planner_stats``) count a value-and-grad's fused hits and misses as the
    reference counts its compiled ``value_and_grad``.  ``guard`` raises
    ``NotImplementedError`` until ROADMAP PEPS item 7 ports the runtime
    guard."""
    if guard not in (None, False):
        raise _not_ported("the runtime guard (guard=)", "PEPS item 7")
    device = resolve_device(device)
    key = key_or_default(key, DEFAULT_VQE_KEY_SEED)
    if isinstance(thetas, torch.Tensor):
        th = thetas.detach().to(device=device, dtype=torch.float64)
    else:
        th = torch.as_tensor(np.asarray(thetas, dtype=np.float64),
                             device=device)
    sig = _grad_signature(nrow, ncol, int(th.shape[0]), obs, update,
                          contract, dtype, device)
    fn = planner.fused_fn(
        "vqe_grad", sig,
        lambda: _build_value_and_grad(nrow, ncol, obs, update, contract,
                                      dtype))
    return fn(th, key)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VQEResult:
    thetas: np.ndarray
    energy: float
    history: List[float]
    n_evals: int
    # planner cache counters over the run
    planner_stats: Optional[dict] = None
    # the reference's runtime-guard report and resume step; the port has
    # neither yet (ROADMAP PEPS item 7), so both stay None
    guard: Optional[object] = None
    resumed_from: Optional[int] = None
    # ensemble runs only (method="adam" or SPSA with ensemble>1): final
    # parameters (ensemble, P), final energies (ensemble,), and the
    # per-iteration per-member energy trace (iterations, ensemble).
    # ``thetas``/``energy``/``history`` then hold the best member / the
    # per-iteration best.
    ensemble_thetas: Optional[np.ndarray] = None
    ensemble_energies: Optional[np.ndarray] = None
    ensemble_history: Optional[np.ndarray] = None


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


def _run_ensemble(nrow, ncol, obs, n_layers, maxiter, method, update,
                  contract, ensemble, cfg, key, energy_key, callback, dtype,
                  device):
    """``maxiter`` adam or SPSA iterations of every member from the
    member-keyed initial angles, one member after another.  Returns the
    final angles, (ensemble, P) float64 on the CPU, and the per-iteration
    energies (ensemble,) of every member."""
    xs = list(_member_init(key, ensemble, n_layers * nrow * ncol))
    if method == "adam":
        moments = [adamw_init(x, torch.float64) for x in xs]

        def advance(i: int, k: int) -> float:
            e, g = vqe_energy_and_grad(xs[i], nrow, ncol, obs, update,
                                       contract, energy_key, dtype=dtype,
                                       device=device)
            xs[i], moments[i], _ = adamw_update(g.cpu(), moments[i], xs[i],
                                                cfg)
            return float(e)
    else:
        a0, c0 = SPSA_GAINS
        spsa_base = key.fold_in(_SPSA_STREAM)

        def energy(x):
            return float(vqe_energy_peps(x.numpy(), nrow, ncol, obs, update,
                                         contract, energy_key, dtype=dtype,
                                         device=device))

        def advance(i: int, k: int) -> float:
            delta = spsa_base.fold_in(k).fold_in(i).rademacher(
                xs[i].shape, torch.float64, "cpu")
            ak = a0 / (1.0 + k) ** 0.602
            ck = c0 / (1.0 + k) ** 0.101
            gplus = energy(xs[i] + ck * delta)
            gminus = energy(xs[i] - ck * delta)
            ghat = (gplus - gminus) / (2.0 * ck) * delta
            xs[i] = xs[i] - ak * ghat
            return 0.5 * (gplus + gminus)

    ehist: List[np.ndarray] = []
    for k in range(maxiter):
        e = np.asarray([advance(i, k) for i in range(ensemble)],
                       dtype=np.float64)
        ehist.append(e)
        if callback is not None:
            best = int(np.argmin(e))
            callback(len(ehist), float(e[best]), xs[best].numpy())
    return torch.stack(xs), ehist


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

    ``guard``, ``checkpoint_dir``/``checkpoint_every`` (and so ``resume``
    from a checkpoint) raise ``NotImplementedError`` until ROADMAP PEPS item
    7, ``mesh`` until PEPS item 9; ``checkpoint_keep`` and ``resume`` are
    accepted for the reference's signature."""
    del checkpoint_keep, resume
    if guard not in (None, False):
        raise _not_ported("the runtime guard (guard=)", "PEPS item 7")
    if checkpoint_dir is not None or checkpoint_every:
        raise _not_ported("checkpoint/resume (checkpoint_dir=)",
                          "PEPS item 7")
    if mesh is not None:
        raise _not_ported("mesh-sharded ensembles (mesh=)", "PEPS item 9")
    device = resolve_device(device)
    # the energies' sketch key, of the caller's key type
    energy_key = (TorchKey if key is None else type(key))(
        DEFAULT_VQE_KEY_SEED)
    n = nrow * ncol
    history: List[float] = []
    planner_before = planner.stats()
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

    def finish(x, e) -> VQEResult:
        return VQEResult(np.asarray(x), float(e), history, len(history),
                         planner_stats=planner.stats_since(planner_before))

    if batched:
        cfg = OptConfig(lr=lr, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.0, grad_clip=10.0)
        xs, ehist = _run_ensemble(
            nrow, ncol, obs, n_layers, maxiter, method_l, update, contract,
            ensemble, cfg, TorchKey(seed) if key is None else key,
            energy_key, callback, dtype, device)
        finals = np.asarray([float(vqe_energy_peps(
            x.numpy(), nrow, ncol, obs, update, contract, energy_key,
            dtype=dtype, device=device)) for x in xs], dtype=np.float64)
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

    if is_spsa:
        x = x0.copy()
        a0, c0 = SPSA_GAINS
        for k in range(maxiter):
            ak = a0 / (1 + k) ** 0.602
            ck = c0 / (1 + k) ** 0.101
            delta = rng.choice([-1.0, 1.0], size=x.shape)
            gplus = objective(x + ck * delta)
            gminus = objective(x - ck * delta)
            ghat = (gplus - gminus) / (2 * ck) * delta
            x = x - ak * ghat
        return finish(x, objective(x))

    from scipy import optimize

    res = optimize.minimize(objective, x0, method=method,
                            options={"maxiter": maxiter, "ftol": 1e-9})
    return finish(res.x, float(res.fun))
