"""Degeneracy-regularized derivatives of the einsumsvd linear-algebra seam.

Counterpart of ``repro.core.svd_grad``.  Each wrapper is a
``torch.autograd.Function`` whose forward is the plain ``torch.linalg``
call (plain-tuple returns) and whose derivative rules replace every
reciprocal spectral gap by its Lorentzian broadening

    1 / d   ->   d / (d^2 + tol^2),     tol = SVD_GRAD_RTOL * scale

(``scale`` = the largest singular value / eigenvalue of the same matrix),
and the QR differential's triangular solve by a ridge solve.  The stock
``torch.linalg`` backward divides by exact gaps: it raises on the gauge
check of a degenerate spectrum (every bond of a product state carries exact
zero singular values) and amplifies near-degenerate ones.  The entries the
regularizer suppresses are intra-subspace gauge rotations, which leave every
gauge-invariant downstream quantity (an energy, an amplitude) unchanged;
the reference module's docstring and ``docs/vqe.md`` give the argument.

``jvp`` (forward mode) is the reference's JVP rule line for line.  JAX
derives reverse mode by transposing that rule; here ``backward`` is its
adjoint written out under the real inner product ``Re <x, y>``, which is
torch's convention: for a real loss and a complex input the gradient is
the conjugate of ``jax.grad``'s.  All rules take leading batch dimensions.
"""
from __future__ import annotations

import cmath

import torch

#: Relative Lorentzian broadening of reciprocal spectral gaps.
SVD_GRAD_RTOL = 1e-12

#: Ridge broadening of the QR differential's triangular inverse.  Looser
#: than ``SVD_GRAD_RTOL``: chained QR shifts compound ``1 / sigma_min``.
QR_GRAD_RTOL = 1e-8


def _h(x: torch.Tensor) -> torch.Tensor:
    return x.mH


def _diag(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1)


def _imag_diag(x: torch.Tensor) -> torch.Tensor:
    """``diag(i Im x_jj)``: the anti-Hermitian part of ``x``'s diagonal
    (zero for a real ``x``)."""
    if not x.is_complex():
        return torch.zeros_like(x)
    return torch.diag_embed(1j * _diag(x).imag).to(x.dtype)


def _broadened_reciprocal(d: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """``d / (d^2 + tol^2)``, exactly zero where both d and tol vanish."""
    denom = d * d + tol * tol
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.where(denom == 0.0, torch.zeros_like(denom), d / safe)


# ---------------------------------------------------------------------------
# SVD
# ---------------------------------------------------------------------------

def _svd_factors(u, s):
    """``f_ij = reg(1 / (s_j^2 - s_i^2))`` and ``reg(1 / s)``, in u's dtype
    and real respectively."""
    smax = s[..., :1]                                 # descending: s[0] = max
    s_row = s[..., None, :]
    s_diffs = (s_row + s_row.mT) * (s_row - s_row.mT)
    tol_f = (SVD_GRAD_RTOL * smax * smax)[..., None, :]
    f = _broadened_reciprocal(s_diffs, tol_f).to(u.dtype)
    s_inv = _broadened_reciprocal(s, SVD_GRAD_RTOL * smax)
    return f, s_inv


def _svd_reg_jvp(u, s, vh, da):
    """Tangents ``(du, ds, dvh)`` of the thin SVD (the reference's rule)."""
    ut, v = _h(u), _h(vh)
    s_row = s[..., None, :].to(u.dtype)
    ds_mat = ut @ da @ v
    ds = _diag(ds_mat).real
    f, s_inv = _svd_factors(u, s)
    dss = s_row * ds_mat                              # dS @ diag(s)
    sds = s_row.mT * ds_mat                           # diag(s) @ dS
    s_inv_row = s_inv[..., None, :].to(u.dtype)
    s_inv_mat = torch.diag_embed(s_inv.to(u.dtype))
    du_dv_diag = 0.5 * (ds_mat - _h(ds_mat)) * s_inv_mat
    du = u @ (f * (dss + _h(dss)) + du_dv_diag)
    dv = v @ (f * (sds + _h(sds)))
    m, n = u.shape[-2], vh.shape[-1]
    if m > n:
        dav = da @ v
        du = du + (dav - u @ (ut @ dav)) * s_inv_row
    if n > m:
        dahu = _h(da) @ u
        dv = dv + (dahu - v @ (_h(v) @ dahu)) * s_inv_row
    return du, ds.to(s.dtype), _h(dv)


def _svd_reg_vjp(u, s, vh, gu, gs, gvh):
    """Adjoint of :func:`_svd_reg_jvp` under ``Re <x, y>``."""
    v = _h(vh)
    gv = _h(gvh)
    f, s_inv = _svd_factors(u, s)
    s_row = s[..., None, :].to(u.dtype)
    s_inv_row = s_inv[..., None, :].to(u.dtype)
    u_bar = _h(u) @ gu
    v_bar = _h(v) @ gv
    uf, vf = f * u_bar, f * v_bar
    # cotangent of ds_mat = u^H da v
    p_bar = ((uf + _h(uf)) * s_row + s_row.mT * (vf + _h(vf))
             + _imag_diag(u_bar) * s_inv_row
             + torch.diag_embed(gs.to(u.dtype)))
    ga = u @ p_bar @ vh
    m, n = u.shape[-2], vh.shape[-1]
    if m > n:
        ga = ga + ((gu - u @ u_bar) * s_inv_row) @ vh
    if n > m:
        ga = ga + (u * s_inv_row) @ _h(gv - v @ v_bar)
    return ga


def _svd(a: torch.Tensor, wide: bool):
    """``torch.linalg.svd(a, full_matrices=False)``; with ``wide``, a
    single-precision matrix on the card is factored in double precision and
    the factors cast back.  The mixed precision policy's solves ask for it:
    cuSOLVER's single-precision Jacobi ``gesvdj``, torch's choice there, is
    less accurate than LAPACK, and across a near-degenerate truncation cut
    it moved the mixed two-layer norm of a 4x4 TFI state 4.4e-5 from the
    exact one (budget 1e-5), widened 1.0e-7, with ``gesvd`` 3.5e-7 at about
    twice the time the widening adds (``tools/precision_drivers.py``)."""
    wider = _WIDER.get(a.dtype) if wide and a.is_cuda else None
    if wider is None:
        return torch.linalg.svd(a, full_matrices=False)
    u, s, vh = torch.linalg.svd(a.to(wider), full_matrices=False)
    return u.to(a.dtype), s.to(a.real.dtype), vh.to(a.dtype)


class SvdReg(torch.autograd.Function):
    """Thin SVD with the regularized derivative (see :func:`svd_reg`)."""

    @staticmethod
    def forward(ctx, a, wide):
        u, s, vh = _svd(a, wide)
        ctx.save_for_backward(u, s, vh)
        ctx.save_for_forward(u, s, vh)
        return u, s, vh

    @staticmethod
    def backward(ctx, gu, gs, gvh):
        return _svd_reg_vjp(*ctx.saved_tensors, gu, gs, gvh), None

    @staticmethod
    def jvp(ctx, da, _wide):
        return _svd_reg_jvp(*ctx.saved_tensors, da)


def svd_reg(a: torch.Tensor, wide: bool = False):
    """Thin SVD ``(u, s, vh)``, values of
    ``torch.linalg.svd(a, full_matrices=False)`` (with ``wide``, in double
    precision for a single-precision matrix on the card, :func:`_svd`),
    with the regularized derivative."""
    return SvdReg.apply(a, wide)


# ---------------------------------------------------------------------------
# Hermitian eigendecomposition
# ---------------------------------------------------------------------------

_WIDER = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def _eigh_forward(a: torch.Tensor):
    """``torch.linalg.eigh`` with the double-precision retry of
    :func:`eigh_reg`."""
    wide = _WIDER.get(a.dtype)
    try:
        w, v = torch.linalg.eigh(a)
        if wide is None or cmath.isfinite((w.sum() + v.sum()).item()):
            return w, v
    except torch.linalg.LinAlgError:
        if wide is None:
            raise
    w, v = torch.linalg.eigh(a.to(wide))
    eigh_reg.widened += 1
    return w.to(a.real.dtype), v.to(a.dtype)


def _eigh_factor(w, v):
    """``f_ij = reg(1 / (w_j - w_i))`` in v's dtype."""
    delta = w[..., None, :] - w[..., None]
    wmax = w.abs().amax(dim=-1, keepdim=True)
    tol = (SVD_GRAD_RTOL * wmax)[..., None, :]
    return _broadened_reciprocal(delta, tol).to(v.dtype)


def _eigh_reg_jvp(w, v, da):
    """Tangents ``(dw, dv)``; the tangent is symmetrized first, as eigh
    reads one triangle of its input."""
    da = 0.5 * (da + _h(da))
    vdag_da_v = _h(v) @ da @ v
    dw = _diag(vdag_da_v).real
    dv = v @ (_eigh_factor(w, v) * vdag_da_v)
    return dw.to(w.dtype), dv


def _eigh_reg_vjp(w, v, gw, gv):
    """Adjoint of :func:`_eigh_reg_jvp` under ``Re <x, y>``."""
    m_bar = (_eigh_factor(w, v) * (_h(v) @ gv)
             + torch.diag_embed(gw.to(v.dtype)))
    b = v @ m_bar @ _h(v)
    ga = 0.5 * (b + _h(b))
    return ga


class EighReg(torch.autograd.Function):
    """Hermitian eigendecomposition with the regularized derivative (see
    :func:`eigh_reg`)."""

    @staticmethod
    def forward(ctx, a):
        w, v = _eigh_forward(a)
        ctx.save_for_backward(w, v)
        ctx.save_for_forward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, gw, gv):
        return _eigh_reg_vjp(*ctx.saved_tensors, gw, gv)

    @staticmethod
    def jvp(ctx, da):
        return _eigh_reg_jvp(*ctx.saved_tensors, da)


def eigh_reg(a: torch.Tensor):
    """Hermitian eigendecomposition ``(w, v)``, ascending ``w``, with the
    regularized derivative.

    cuSOLVER's single-precision ``heevd`` fails on some finite, strongly
    graded matrices (seen on the H100 in complex64 ITE Grams and
    full-update environments): it raises, or it returns NaN without
    raising, where LAPACK and the double-precision solver succeed.  A
    single-precision result that raised or is not finite is computed once
    more in double precision and cast back, inside the forward; the count
    of these retries is ``eigh_reg.widened``.  The test reads one sum of
    ``w`` and ``v`` (NaN or inf in either shows in it; ``|v| <= 1`` cannot
    overflow), three small kernels and one read after the read ``eigh``
    itself makes on the card.  A non-finite input still gives a non-finite
    result or raises."""
    return EighReg.apply(a)


eigh_reg.widened = 0


# ---------------------------------------------------------------------------
# QR
# ---------------------------------------------------------------------------

def _qr_ridge(r):
    """The Hermitian positive-definite ``r r^H + tol^2 I`` of the ridge."""
    n = r.shape[-1]
    rdiag = _diag(r).abs()
    tol = QR_GRAD_RTOL * rdiag.amax(dim=-1, keepdim=True)
    tol = torch.where(tol == 0.0, torch.ones_like(tol), tol)
    eye = torch.eye(n, dtype=r.dtype, device=r.device)
    return r @ _h(r) + (tol * tol)[..., None].to(r.dtype) * eye


def _right_solve(x, gram):
    """``x gram^{-1}`` for Hermitian ``gram``, as the reference solves it."""
    return torch.linalg.solve(gram.mT, x.mT).mT


def _check_tall(r):
    if r.shape[-2] < r.shape[-1]:                     # a wide: r is k x n
        raise NotImplementedError(
            "qr_reg derivative is tall/square only (same contract as "
            "jnp.linalg.qr)")


def _qr_skew(y):
    """``tril(y, -1) - tril(y, -1)^H + diag(i Im y_jj)`` (the reference's
    ``do``)."""
    lower = torch.tril(y, -1)
    return lower - _h(lower) + _imag_diag(y)


def _qr_reg_jvp(q, r, da):
    _check_tall(r)
    dx_rinv = _right_solve(da @ _h(r), _qr_ridge(r))
    qt_dx_rinv = _h(q) @ dx_rinv
    do = _qr_skew(qt_dx_rinv)
    dq = q @ (do - qt_dx_rinv) + dx_rinv
    dr = (qt_dx_rinv - do) @ r
    return dq, dr


def _qr_reg_vjp(q, r, gq, gr):
    """Adjoint of :func:`_qr_reg_jvp`: the adjoint of ``_qr_skew`` is
    ``tril(b, -1) - triu(b, 1)^H + diag(i Im b_jj)``, and the ridge solve
    is its own adjoint (its matrix is Hermitian)."""
    _check_tall(r)
    b = _h(q) @ gq - gr @ _h(r)
    y_bar = (torch.tril(b, -1) - _h(torch.triu(b, 1)) + _imag_diag(b)) - b
    x_bar = gq + q @ y_bar
    ga = _right_solve(x_bar, _qr_ridge(r)) @ r
    return ga


class QrReg(torch.autograd.Function):
    """Reduced QR with the ridge-regularized derivative (see
    :func:`qr_reg`)."""

    @staticmethod
    def forward(ctx, a):
        q, r = torch.linalg.qr(a)
        ctx.save_for_backward(q, r)
        ctx.save_for_forward(q, r)
        return q, r

    @staticmethod
    def backward(ctx, gq, gr):
        return _qr_reg_vjp(*ctx.saved_tensors, gq, gr)

    @staticmethod
    def jvp(ctx, da):
        return _qr_reg_jvp(*ctx.saved_tensors, da)


def qr_reg(a: torch.Tensor):
    """Reduced QR ``(q, r)``, values of ``torch.linalg.qr(a)``.  The
    derivative replaces ``X r^{-1}`` by the ridge
    ``X r^H (r r^H + tol^2 I)^{-1}``, ``tol = QR_GRAD_RTOL * max|r_jj|``;
    only the tall/square case (``m >= n``) is differentiable."""
    return QrReg.apply(a)


# ---------------------------------------------------------------------------
# sqrt
# ---------------------------------------------------------------------------

def _sqrt_factor(r):
    safe = torch.where(r == 0.0, torch.ones_like(r), r)
    return torch.where(r == 0.0, torch.zeros_like(r), 0.5 / safe)


class SqrtReg(torch.autograd.Function):
    """``torch.sqrt`` whose derivative is 0 at exactly 0."""

    @staticmethod
    def forward(ctx, s):
        r = torch.sqrt(s)
        ctx.save_for_backward(r)
        ctx.save_for_forward(r)
        return r

    @staticmethod
    def backward(ctx, gr):
        return _sqrt_factor(*ctx.saved_tensors) * gr

    @staticmethod
    def jvp(ctx, ds):
        return _sqrt_factor(*ctx.saved_tensors) * ds


def sqrt_reg(s: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt`` whose derivative is taken as 0 at exactly 0 (the zero
    singular values of a rank-deficient bond multiply a zero factor
    downstream, so the symmetric subgradient 0 is the finite choice)."""
    return SqrtReg.apply(s)
