"""Variational boundary engine: ALS-fitted fixed-chi boundary MPS.

Counterpart of ``repro.core.engines.variational``.  Where the zip-up engine
truncates greedily (the einsumsvd at column ``j`` cannot see the columns to
its right), this engine solves the global fixed-chi problem of one row
absorption,

    minimize  || B  -  O · S ||_F   over MPS B with bond <= chi,

where ``O · S`` (the row MPO applied to the incoming boundary MPS) is never
formed.  Alternating least squares in mixed canonical form (the MPO-MPS
fitting of Lubasch et al., arXiv:1405.3259): with every tensor of ``B`` but
site ``j`` fixed and orthonormal, the optimal ``B_j`` is the projection
``L_j · (S_j O_j) · R_{j+1}``.  A left-to-right pass QR-shifts the center
as it updates, a right-to-left pass mirrors it; ``sweeps`` round trips
follow a zip-up seed computed with the same ``svd`` option and key.

Every environment step and local update is one callable per network
signature through :func:`repro_torch.core.planner.fused_fn` (tags
``varfit_*``), and every einsum inside runs through
:func:`repro_torch.core.planner.cached_einsum`, so the interior columns of
a row, later rows and repeated absorptions replay cache entries.  The ALS
steps are chains of small einsums and QRs: they reach no kernel site.  The
zip-up seed does.

An ALS sweep needs the whole row, so ``supports_blocks = False``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core import planner
from repro_torch.core.engines import BoundaryEngine, register_engine
from repro_torch.core.svd_grad import qr_reg


def _fused(tag: str, make, *tensors):
    """Run ``make()``'s function on ``tensors``, cached per signature: the
    operands' shapes and dtypes and the device type."""
    sig = (tuple(tuple(t.shape) for t in tensors),
           tuple(str(t.dtype).replace("torch.", "") for t in tensors),
           tensors[0].device.type)
    fn = planner.fused_fn(tag, sig, make)
    return fn(*tensors)


def _qr_shift_right(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """QR of ``b`` matricized as (left+dangles, right): the left-orthonormal
    Q in ``b``'s layout, and r to absorb rightwards.  ``qr_reg`` is
    ``torch.linalg.qr`` forward, with the ridge-regularized derivative."""
    m = b.shape[-1]
    q, r = qr_reg(b.reshape(-1, m))
    return q.reshape(b.shape[:-1] + (q.shape[-1],)), r


def _lq_shift_left(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LQ of ``b`` matricized as (left, dangles+right): r to absorb
    leftwards, and the right-orthonormal Q in ``b``'s layout."""
    a = b.shape[0]
    qh, rh = qr_reg(b.reshape(a, -1).mH)
    q = qh.mH                  # (k, dangles*right), right-orthonormal rows
    r = rh.mH                  # (a, k)
    return r, q.reshape((q.shape[0],) + b.shape[1:])


# ---------------------------------------------------------------------------
# Per-site fit steps.  ``site`` is (s_j, o_j) one-layer or (s_j, bra_j,
# ket_j) two-layer; the einsum strings mirror the zip-up labels.
# ---------------------------------------------------------------------------

_NETS = {
    # nsite tensors: (M from left, B from M·R, L-advance, M from right,
    #                 B from L·M, R-advance)
    2: {  # one-layer: s (b,f,g)=(l,d,r), o (f,c,h,k)=(u,l,d,r)
        "Ml": ("bca,bfg,fchk->ahgk", "ahgk,gkm->ahm", "ahgk,ahn->gkn"),
        "Mr": ("gkm,bfg,fchk->bchm", "bca,bchm->ahm", "bchm,nhm->bcn"),
    },
    3: {  # two-layer: s (b,f,F,g), bra* (p,f,c,h,k), ket (p,F,C,H,K)
        "Ml": ("bcCa,bfFg,pfchk,pFCHK->ahHgkK", "ahHgkK,gkKm->ahHm",
               "ahHgkK,ahHn->gkKn"),
        "Mr": ("gkKm,bfFg,pfchk,pFCHK->bcChHm", "bcCa,bcChHm->ahHm",
               "bcChHm,nhHm->bcCn"),
    },
}


def _site_tensors(site: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The network operands of one column (bra conjugated, two-layer)."""
    if len(site) == 3:
        s, bra, ket = site
        return [s, bra.conj(), ket]
    return list(site)


def _step_lr(L, site, R, last: bool):
    """One left-to-right local update: fit ``B_j``, QR-shift, advance L.
    Returns ``(B_j, L_next)``; at the last site the fit keeps the norm and
    ``L_next`` is None."""
    ops = _site_tensors(site)
    net = _NETS[len(ops)]["Ml"]

    if last:
        def build():
            def run(L, *rest):
                m = planner.cached_einsum(net[0], L, *rest[:-1])
                return planner.cached_einsum(net[1], m, rest[-1])
            return run
        return _fused("varfit_lr_last", build, L, *ops, R), None

    def build():
        def run(L, *rest):
            m = planner.cached_einsum(net[0], L, *rest[:-1])
            q, _ = _qr_shift_right(planner.cached_einsum(net[1], m, rest[-1]))
            return q, planner.cached_einsum(net[2], m, q.conj())
        return run
    return _fused("varfit_lr", build, L, *ops, R)


def _step_rl(R, site, L, first: bool):
    """One right-to-left local update: fit ``B_j``, LQ-shift, advance R.
    Returns ``(B_j, R_prev)``; at the first site the fit is kept whole."""
    ops = _site_tensors(site)
    net = _NETS[len(ops)]["Mr"]

    if first:
        def build():
            def run(R, *rest):
                m = planner.cached_einsum(net[0], R, *rest[:-1])
                return planner.cached_einsum(net[1], rest[-1], m)
            return run
        return _fused("varfit_rl_first", build, R, *ops, L), None

    def build():
        def run(R, *rest):
            m = planner.cached_einsum(net[0], R, *rest[:-1])
            _, q = _lq_shift_left(planner.cached_einsum(net[1], rest[-1], m))
            return q, planner.cached_einsum(net[2], m, q.conj())
        return run
    return _fused("varfit_rl", build, R, *ops, L)


def _renv_step(R, site, b):
    """Extend the right fit environment over one column (uses conj(b))."""
    ops = _site_tensors(site)
    net = _NETS[len(ops)]["Mr"]

    def build():
        def run(R, *rest):
            m = planner.cached_einsum(net[0], R, *rest[:-1])
            return planner.cached_einsum(net[2], m, rest[-1].conj())
        return run
    return _fused("varfit_renv", build, R, *ops, b)


def _canonicalize_right(bs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Right-canonicalize an MPS (LQ sweep, right to left)."""
    bs = list(bs)

    def build():
        def run(prev, cur):
            r, q = _lq_shift_left(cur)
            return torch.tensordot(prev, r, dims=([prev.dim() - 1], [0])), q
        return run

    for j in range(len(bs) - 1, 0, -1):
        bs[j - 1], bs[j] = _fused("varfit_canon", build, bs[j - 1], bs[j])
    return bs


class VariationalEngine(BoundaryEngine):
    """ALS boundary-MPS fitting engine (the module docstring has the math).

    ``sweeps``: full ALS round trips (left-to-right + right-to-left) per row
    absorption; ``sweeps=0`` is the zip-up seed itself."""

    name = "variational"
    supports_blocks = False

    def __init__(self, sweeps: int = 2):
        if sweeps < 0:
            raise ValueError(f"sweeps must be >= 0, got {sweeps}")
        self.sweeps = sweeps

    def __repr__(self):
        return f"VariationalEngine(sweeps={self.sweeps})"

    def _fit(self, sites: List[Sequence[torch.Tensor]],
             seed: List[torch.Tensor]) -> List[torch.Tensor]:
        """ALS-fit an MPS, seeded by ``seed``, to the column network
        ``sites`` (per column: the operand tuple)."""
        ncol = len(sites)
        if ncol < 2 or self.sweeps == 0:
            return seed    # a single column is exact; sweeps=0 is the seed
        nb = len(_site_tensors(sites[0])) + 1  # env rank: bonds + B bond
        triv = torch.ones((1,) * nb, dtype=seed[0].dtype,
                          device=seed[0].device)
        bs = _canonicalize_right(seed)
        renvs: List = [None] * (ncol + 1)
        renvs[ncol] = triv
        for j in range(ncol - 1, 0, -1):
            renvs[j] = _renv_step(renvs[j + 1], sites[j], bs[j])
        for _ in range(self.sweeps):
            # left-to-right pass (bs left-canonical, center at the end)
            lenvs: List = [triv] + [None] * ncol
            for j in range(ncol):
                lastp = j == ncol - 1
                bs[j], ln = _step_lr(lenvs[j], sites[j], renvs[j + 1], lastp)
                if not lastp:
                    lenvs[j + 1] = ln
            # right-to-left pass (bs right-canonical, center at 0; rebuilds
            # renvs for the next sweep)
            for j in range(ncol - 1, -1, -1):
                firstp = j == 0
                bs[j], rn = _step_rl(renvs[j + 1], sites[j], lenvs[j], firstp)
                if not firstp:
                    renvs[j] = rn
        return bs

    def _fit_with_policy(self, sites, seed, svd):
        """:meth:`_fit` under the svd option's precision policy: with the
        mixed policy the site tensors and the seed are demoted one storage
        tier for the sweeps and the fitted boundary is promoted back; the
        exact policy passes through."""
        from repro_torch.core.precision import demote, policy_of
        pol = policy_of(svd)
        if not pol.demote:
            return self._fit(sites, seed)
        orig_dtype = seed[0].dtype
        sites_d = [tuple(demote(t, pol) for t in site) for site in sites]
        out = self._fit(sites_d, [demote(t, pol) for t in seed])
        return [t.to(orig_dtype) for t in out]

    def absorb_onelayer(self, svec, row, chi, svd, key):
        from repro_torch.core.engines.zipup import _zipup_row
        seed = _zipup_row(svec, row, chi, svd, key)
        return self._fit_with_policy(
            [(svec[j], row[j]) for j in range(len(svec))], seed, svd)

    def absorb_twolayer(self, svec, bra_row, ket_row, chi, svd, key):
        from repro_torch.core.engines.zipup import _zipup_row_twolayer
        seed = _zipup_row_twolayer(svec, bra_row, ket_row, chi, svd, key)
        return self._fit_with_policy(
            [(svec[j], bra_row[j], ket_row[j]) for j in range(len(svec))],
            seed, svd)

    def final_scalar_onelayer(self, svec):
        from repro_torch.core.engines.zipup import _mps_to_scalar
        return _mps_to_scalar(svec)

    def final_scalar_twolayer(self, svec):
        from repro_torch.core.engines.zipup import _twolayer_final_scalar
        return _twolayer_final_scalar(svec)


register_engine(VariationalEngine())
