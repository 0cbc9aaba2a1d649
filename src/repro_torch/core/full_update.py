"""Full (environment-aware) two-site updates for PEPS imaginary time evolution.

Counterpart of ``repro.core.full_update``.  The QR simple update truncates
the bond of a two-site gate as if the rest of the network were the
identity; the full update of Lubasch, Cirac & Bañuls (arXiv:1405.3259)
truncates in the metric of the two-site neighborhood environment, so that
the physical state changes as little as possible.

Pipeline per bond (horizontal or vertical; the environment is
orientation-specific):

1. **Reduced split** — Gram-QR both site tensors (paper Alg. 5, the
   ``gram`` and ``tall_apply`` dispatch sites) so only the small reduced
   tensors ``Ra``/``Rb`` carrying (physical, bond) are optimized.
2. **Neighborhood environment** — the cached top/bottom row environments,
   a left/right strip boundary and the ``Q`` isometries contract into the
   bond environment ``E`` (ten operands through the planner's path cache).
3. **Positive fix** — hermitize ``E``, clamp its spectrum to PSD, divide by
   its largest eigenvalue.
4. **ALS** — seed with the einsumsvd split of the gate-applied reduced
   network, then a fixed number of regularized alternating least-squares
   sweeps minimizing ``||theta - a.b||_E``.
5. **Reabsorb** the ``Q`` isometries and write the sites back.

Steps 3–4 run as one callable per network signature, memoized through
:func:`planner.fused_fn` (eager: PyTorch compiles nothing, but the cache and
its ``fused_hits``/``fused_misses`` counters keep the reference's
structure).  The ALS objective yields the bond truncation fidelity

    F = |<ab|E|theta>|^2 / (<ab|E|ab> <theta|E|theta>),

kept on the device per bond and read by :func:`drain_fidelities`.

Under an active runtime guard (:mod:`repro_torch.core.runtime_guard`) each
bond's ALS result is checked, and a failed bond is retried once from a
DirectSVD seed.
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import torch

from repro_torch.core import gates as _gates
from repro_torch.core import planner, runtime_guard
from repro_torch.core.bmps import BMPS
from repro_torch.core.einsumsvd import DirectSVD, einsumsvd
from repro_torch.core.environments import row_environments, strip_boundary
from repro_torch.core.orthogonalize import gram_qr
from repro_torch.core.precision import PrecisionWrapped
from repro_torch.core.svd_grad import eigh_reg

# ---------------------------------------------------------------------------
# Fidelity log (drained by ite.ite_run)
# ---------------------------------------------------------------------------

_FIDELITY_LOG: List[torch.Tensor] = []
# Callers that never drain must not leak: keep only the latest entries.
_FIDELITY_LOG_MAX = 4096


def _host(log) -> List[float]:
    """One device-to-host copy for the whole window."""
    return torch.stack(log).cpu().tolist() if log else []


def drain_fidelities() -> List[float]:
    """Pop all bond fidelities logged since the last drain.  They are kept
    as device scalars and copied to the host here, once for the window, so
    logging a bond never waits for the device."""
    out = _host(_FIDELITY_LOG)
    _FIDELITY_LOG.clear()
    return out


def pending_fidelities() -> List[float]:
    """The undrained window, copied to the host, without clearing it."""
    return _host(_FIDELITY_LOG)


def restore_fidelities(values, device) -> None:
    """Replace the undrained window with ``values`` on ``device`` (the
    resume path; pairs with :func:`pending_fidelities`)."""
    _FIDELITY_LOG.clear()
    _FIDELITY_LOG.extend(torch.tensor(float(v), dtype=torch.float64,
                                      device=device) for v in values)


def _log_fidelity(f: torch.Tensor) -> None:
    if len(_FIDELITY_LOG) >= _FIDELITY_LOG_MAX:
        del _FIDELITY_LOG[0]
    _FIDELITY_LOG.append(f.detach())


# ---------------------------------------------------------------------------
# Environment extraction
# ---------------------------------------------------------------------------

def env_option(update) -> BMPS:
    """The boundary-MPS option of this update's row environments:
    ``FullUpdate.env_contract`` when set, else ``BMPS(chi, env_svd)``."""
    if update.env_contract is not None:
        return update.env_contract
    svd = update.env_svd
    if isinstance(svd, PrecisionWrapped):
        # keep the policy: BMPS's default "exact" would unwrap the option
        return BMPS(update.chi, svd, precision=svd.policy)
    return BMPS(update.chi, svd)


def envs_compatible(state, s0: Tuple[int, int], s1: Tuple[int, int],
                    envs) -> bool:
    """Do the cached row environments still fit the current bond dimensions?

    A bond that grew since the sweep (the first ITE steps from a product
    state, SWAP chains) makes them shape-stale: einsum would broadcast their
    dim-1 axes into a meaningless metric or fail.  Callers refresh when this
    returns False."""
    (i0, _), (i1, _) = s0, s1
    top, bottom = envs
    t_env, b_env = top[min(i0, i1)], bottom[max(i0, i1)]
    for c in range(state.ncol):
        u = state.sites[min(i0, i1)][c].shape[1]
        d = state.sites[max(i0, i1)][c].shape[3]
        if t_env[c].shape[1] != u or t_env[c].shape[2] != u:
            return False
        if b_env[c].shape[1] != d or b_env[c].shape[2] != d:
            return False
    return True


def bond_environment(state, s0: Tuple[int, int], s1: Tuple[int, int],
                     qa, qb, envs) -> torch.Tensor:
    """Neighborhood environment of the bond ``s0 -> s1`` (right or down).

    ``qa``/``qb`` are the reduced-split isometries of the two sites (their
    last two axes are the open reduced-bond pair); ``envs`` is the
    ``(top, bottom)`` pair of :func:`environments.row_environments`.
    Returns ``E`` with eight axes: the bra reduced-bond pairs of a and b,
    then the ket pairs — ``(A1,A2,C1,C2,a1,a2,c1,c2)``."""
    (i, j), (i1, _) = s0, s1
    top, bottom = envs
    sites = state.sites
    if i == i1:                                          # horizontal bond
        t_env, b_env = top[i], bottom[i]
        bra = [sites[i]]
        left = strip_boundary(t_env, b_env, bra, bra, j, from_left=True)
        right = strip_boundary(t_env, b_env, bra, bra, j + 2, from_left=False)
        # labels: open bra pair (11,12 / 13,14), open ket pair (15,16 / 17,18)
        return planner.int_einsum(
            left, [1, 2, 3, 4],                          # (t, bra_l, ket_l, bt)
            t_env[j], [1, 5, 6, 7],
            t_env[j + 1], [7, 8, 9, 10],
            qa.conj(), [5, 2, 20, 11, 12],               # (u, l, d, A1, A2)
            qa, [6, 3, 21, 15, 16],
            qb.conj(), [8, 22, 24, 13, 14],              # (U, D, R, C1, C2)
            qb, [9, 23, 25, 17, 18],
            b_env[j], [4, 20, 21, 26],
            b_env[j + 1], [26, 22, 23, 27],
            right, [10, 24, 25, 27],
            [11, 12, 13, 14, 15, 16, 17, 18])
    # vertical bond: two-row strip, rows i and i+1
    t_env, b_env = top[i], bottom[i + 1]
    bra = [sites[i], sites[i + 1]]
    left = strip_boundary(t_env, b_env, bra, bra, j, from_left=True)
    right = strip_boundary(t_env, b_env, bra, bra, j + 1, from_left=False)
    return planner.int_einsum(
        left, [1, 2, 3, 4, 5, 6],        # (t, braA_l, ketA_l, braB_l, ketB_l, bt)
        t_env[j], [1, 7, 8, 9],
        qa.conj(), [7, 2, 20, 11, 12],                   # (u, l, r, A1, A2)
        qa, [8, 3, 21, 15, 16],
        qb.conj(), [4, 22, 24, 13, 14],                  # (l, d, r, C1, C2)
        qb, [5, 23, 25, 17, 18],
        b_env[j], [6, 22, 23, 27],
        right, [9, 20, 21, 24, 25, 27],
        [11, 12, 13, 14, 15, 16, 17, 18])


def _matrix(env: torch.Tensor) -> torch.Tensor:
    """The (bra pairs | ket pairs) matrix view of an 8-axis environment."""
    sh = env.shape
    d = sh[0] * sh[1] * sh[2] * sh[3]
    return env.reshape(d, d)


def positive_fix(env: torch.Tensor) -> torch.Tensor:
    """Hermitize and clamp the bond environment to PSD, divided by its
    largest eigenvalue.  Truncated boundary contractions leave E only
    approximately Hermitian and positive; used raw it can steer the ALS to
    unphysical solutions (Lubasch et al., Section IV-B2)."""
    m = _matrix(env)
    m = 0.5 * (m + m.mH)
    w, v = eigh_reg(m)
    w = torch.clamp(w, min=0.0)
    scale = torch.clamp(w.max(), min=torch.finfo(w.dtype).tiny)
    return ((v * (w / scale).to(v.dtype)) @ v.mH).reshape(env.shape)


# ---------------------------------------------------------------------------
# ALS bond optimization (one memoized callable per signature)
# ---------------------------------------------------------------------------

def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.real.dtype).tiny


def _env_overlap(env, p, q):
    """<p|E|q> for pair tensors (a,b,x,y,c,d) over the metric E."""
    return planner.cached_einsum("ABxyCD,ABCDabcd,abxycd->", p.conj(), env, q)


def _pair(a, b):
    """Merge reduced factors a:(a,b,x,m), b:(m,y,c,d) into (a,b,x,y,c,d)."""
    return planner.cached_einsum("abxm,mycd->abxycd", a, b)


def _regularized_solve(m, rhs, eps):
    """Solve ``(m + reg I) x = rhs`` with ``reg`` relative to the mean
    diagonal.  ``solve_ex`` without its error check: on CUDA the check
    waits for the device, and a singular system gives non-finite values, as
    ``jnp.linalg.solve`` does in the reference."""
    d = m.shape[0]
    reg = eps * (torch.diagonal(m).sum().real / d + _tiny(m))
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    return torch.linalg.solve_ex(m + reg * eye, rhs, check_errors=False)[0]


def _als_sweep(env, theta, a, b, eps):
    """One alternating sweep: re-solve a given b, then b given a."""
    # a given b:  M_a a = S_a, block-diagonal in the physical index x
    ma = planner.cached_einsum("MyCD,ABCDabcd,mycd->ABMabm", b.conj(), env, b)
    sa = planner.cached_einsum("MyCD,ABCDabcd,abxycd->ABMx",
                               b.conj(), env, theta)
    da, db_, dx, dm = a.shape
    n = da * db_ * dm
    sol = _regularized_solve(ma.reshape(n, n), sa.reshape(n, dx), eps)
    a = sol.reshape(da, db_, dm, dx).movedim(3, 2)
    # b given a
    mb = planner.cached_einsum("ABxM,ABCDabcd,abxm->MCDmcd", a.conj(), env, a)
    sb = planner.cached_einsum("ABxM,ABCDabcd,abxycd->MCDy",
                               a.conj(), env, theta)
    _, dy, dc, dd = b.shape
    n = dm * dc * dd
    sol = _regularized_solve(mb.reshape(n, n), sb.reshape(n, dy), eps)
    b = sol.reshape(dm, dc, dd, dy).movedim(3, 1)
    return a, b


def _optimize_bond(env, theta, a0, b0, *, n_iter: int, eps: float,
                   positive: bool):
    """Positive-fix the environment, run ALS, return (a, b, fidelity)."""
    if positive:
        env = positive_fix(env)
    else:
        m = _matrix(env)
        env = (0.5 * (m + m.mH)).reshape(env.shape)
    a, b = a0, b0
    for _ in range(n_iter):
        a, b = _als_sweep(env, theta, a, b, eps)
    # norm-balance the shared bond (gauge hygiene for long evolutions)
    na = torch.clamp(torch.linalg.vector_norm(a), min=_tiny(a))
    nb = torch.clamp(torch.linalg.vector_norm(b), min=_tiny(b))
    g = torch.sqrt(nb / na)
    a, b = a * g, b / g
    ab = _pair(a, b)
    num = _env_overlap(env, ab, theta)
    d1 = _env_overlap(env, ab, ab).real
    d2 = _env_overlap(env, theta, theta).real
    fid = num.abs() ** 2 / torch.clamp(d1 * d2, min=_tiny(a))
    return a, b, fid


def _guarded_optimize(guard, env, theta, left, right, update):
    """:func:`_fused_optimize` from the einsumsvd seed ``(left, right)``,
    with its failure cause under an active ``guard`` (None when healthy
    or unguarded).  Under a guard a ``torch.linalg.LinAlgError`` of the
    positive fix or the ALS solves counts as ``"nan"``: cuSOLVER raises
    where the reference's eigh returns NaN.  Unguarded it propagates."""
    try:
        ar, br, fid = _fused_optimize(env, theta, left.movedim(0, 2), right,
                                      update)
    except torch.linalg.LinAlgError:
        if guard is None:
            raise
        return None, None, None, "nan"
    if guard is None:
        return ar, br, fid, None
    return ar, br, fid, runtime_guard.check_bond(guard, ar, br, fid)


def _fused_optimize(env, theta, a0, b0, update):
    sig = (tuple(env.shape), tuple(theta.shape), tuple(a0.shape),
           tuple(b0.shape), str(env.dtype).replace("torch.", ""),
           update.als_iters, update.als_eps, update.positive,
           env.device.type)
    make = lambda: partial(_optimize_bond, n_iter=update.als_iters,
                           eps=update.als_eps, positive=update.positive)
    return planner.fused_fn("full-update-als", sig, make)(env, theta, a0, b0)


# ---------------------------------------------------------------------------
# The full update itself
# ---------------------------------------------------------------------------

def _reduced_split(t: torch.Tensor, axes: Tuple[int, ...]):
    """Gram-QR ``t`` with its axes permuted to ``axes`` (last two = small)."""
    return gram_qr(t.permute(axes), 2)


def full_update_bond(state, g, s0: Tuple[int, int], s1: Tuple[int, int],
                     update, key, envs=None):
    """Apply a two-site gate on adjacent sites with the full update.

    ``envs`` is an optional cached ``(top, bottom)`` pair from
    :func:`environments.row_environments`; omitted or shape-stale, it is
    recomputed from the current state.  Returns the new state; the bond
    fidelity goes to the module log (:func:`drain_fidelities`)."""
    (i0, j0), (i1, j1) = s0, s1
    g = _gates.as_tensor(g, state.sites[i0][j0])
    # canonical orientations: left->right or top->bottom
    if (i0 == i1 and j1 == j0 - 1) or (j0 == j1 and i1 == i0 - 1):
        return full_update_bond(state, g.permute(1, 0, 3, 2), s1, s0, update,
                                key, envs)
    if not ((i0 == i1 and j1 == j0 + 1) or (j0 == j1 and i1 == i0 + 1)):
        raise ValueError(f"sites {s0}, {s1} are not adjacent")

    key, env_key, seed_key = key.split(3)
    if envs is None or not envs_compatible(state, s0, s1, envs):
        envs = row_environments(state, env_option(update), env_key)

    a = state.sites[i0][j0]
    b = state.sites[i1][j1]
    horizontal = i0 == i1
    if horizontal:
        # a:(p,u,l,d,k) bond=r ; b:(q,U,k,D,R) bond=l
        qa, ra = _reduced_split(a, (1, 2, 3, 0, 4))      # qa:(u,l,d,A1,A2)
        qb, rb = _reduced_split(b, (1, 3, 4, 0, 2))      # qb:(U,D,R,C1,C2)
    else:
        # a:(p,u,l,d,r) bond=d ; b:(q,u,l,d,r) bond=u
        qa, ra = _reduced_split(a, (1, 2, 4, 0, 3))      # qa:(u,l,r,A1,A2)
        qb, rb = _reduced_split(b, (2, 3, 4, 0, 1))      # qb:(l,d,r,C1,C2)

    env = bond_environment(state, s0, s1, qa, qb, envs)

    # the gate-applied reduced pair and its einsumsvd seed (the simple
    # update's answer in the reduced gauge; ALS only improves on it)
    theta = planner.cached_einsum("xypq,abpk,cdqk->abxycd", g, ra, rb)
    left, right = einsumsvd(
        update.svd, [g, ra, rb], ["xypq", "abpk", "cdqk"],
        row="xab", col="ycd", rank=update.rank, absorb="both", key=seed_key)
    guard = runtime_guard.current()
    ar, br, fid, cause = _guarded_optimize(guard, env, theta, left, right,
                                           update)       # a0:(a,b,x,m)
    if cause is not None:
        # runtime-guard hook: a non-finite ALS result (or a LinAlgError of
        # its positive fix or solves) or a fidelity below the floor retries
        # the bond once from a deterministic DirectSVD seed; NaN after the
        # retry raises GuardExhaustedError, a low fidelity is accepted
        # degraded unless fidelity_strict
        runtime_guard.bond_failure(guard, cause, retried=False,
                                   detail=f"bond {s0}->{s1}")
        left, right = einsumsvd(
            DirectSVD(), [g, ra, rb], ["xypq", "abpk", "cdqk"],
            row="xab", col="ycd", rank=update.rank, absorb="both",
            key=seed_key)
        ar, br, fid, recheck = _guarded_optimize(guard, env, theta, left,
                                                 right, update)
        if recheck is None:
            runtime_guard.bond_recovered(guard, cause)
        else:
            fid_s = f"{fid.real.item():.3e}" if fid is not None else "n/a"
            runtime_guard.bond_failure(
                guard, recheck, retried=True,
                detail=f"bond {s0}->{s1} fid={fid_s}")
    _log_fidelity(fid)

    if horizontal:
        new_a = planner.cached_einsum("uldab,abxm->xuldm", qa, ar)
        new_b = planner.cached_einsum("UDRcd,mycd->yUmDR", qb, br)
    else:
        new_a = planner.cached_einsum("ulrab,abxm->xulmr", qa, ar)
        new_b = planner.cached_einsum("LDRcd,mycd->ymLDR", qb, br)
    new = state.copy()
    new.sites[i0][j0] = new_a
    new.sites[i1][j1] = new_b
    return new
