"""Reshape-avoiding orthogonalization via Gram matrices (paper Alg. 5).

Counterpart of ``repro.core.orthogonalize``.  ``gram_qr`` forms the small
Gram matrix ``G = A^H A`` with a contraction over the big modes,
eigendecomposes G, and reconstitutes the isometry ``Q = A P`` with one more
GEMM.  Two kernel-dispatch sites (:mod:`repro_torch.kernels.dispatch`):

* ``"gram"``       — G = A^H A: the streaming-Gram kernel
  (``src/repro_torch/kernels/gram.py``; complex64 through ``gram_complex``,
  one kernel that reads the interleaved storage once);
* ``"tall_apply"`` — Q = A P and the final rSVD projections: the
  tall-apply kernel (``src/repro_torch/kernels/matvec.py``).

Under the mixed precision policy the Gram multiplies in bf16 and its
eigenvalues are clamped at bf16's resolution; Q = A P keeps the operand's
multiplicands (``tall_project(..., own_dtype=True)``), as P = R^{-1} is
ill-conditioned.

f64/c128 operands stay dense (the hard dtype gate).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.svd_grad import eigh_reg
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels.gram import gram, gram_complex
from repro_torch.kernels.matvec import planar_matmul

_EPS = {torch.float32: 1e-6, torch.float64: 1e-13,
        torch.complex64: 1e-6, torch.complex128: 1e-13,
        torch.bfloat16: 1e-3}


def _eps_for(dtype) -> float:
    return _EPS.get(dtype, 1e-6)


# The reference's first names for the kernel-dispatch controls, kept as
# aliases of the registry-wide ones.  They take the port's mode names and the
# reference's "pallas", which means "kernel".
_GRAM_MODES = {"auto": "auto", "kernel": "kernel", "pallas": "kernel",
               "dense": "dense"}


def set_gram_backend(mode: str) -> str:
    """Select the global kernel mode: ``'auto'``, ``'kernel'`` (or the
    reference's ``'pallas'``) or ``'dense'``.  Returns the previous mode.
    Alias of :func:`repro_torch.kernels.dispatch.set_kernel_backend`."""
    if mode not in _GRAM_MODES:
        raise ValueError(f"bad gram backend {mode!r}")
    return _dispatch.set_kernel_backend(_GRAM_MODES[mode])


def gram_backend() -> str:
    """The global kernel mode."""
    return _dispatch.kernel_backend()


def gram_dispatch_stats() -> dict:
    """Per-site kernel/dense call counters (all sites, not only the Gram)."""
    return _dispatch.dispatch_stats()


def reset_gram_dispatch_stats() -> None:
    _dispatch.reset_dispatch_stats()


def _gram_dense(a: torch.Tensor, big_axes, nbig: int, nsmall: int):
    g = torch.tensordot(a.conj(), a, dims=(list(big_axes), list(big_axes)))
    return g.reshape(nsmall, nsmall)


def _gram_kernel(a: torch.Tensor, big_axes, nbig: int, nsmall: int):
    mat = a.reshape(nbig, nsmall).contiguous()
    compute = _dispatch.kernel_compute()
    if a.is_complex():
        return gram_complex(mat, compute=compute)
    return gram(mat, compute=compute)


_dispatch.register_kernel(
    "gram", kernel=_gram_kernel, dense=_gram_dense,
    supported=lambda a, big_axes, nbig, nsmall:
        _dispatch.dtype_supported(a.dtype),
    auto=lambda a, big_axes, nbig, nsmall:
        _dispatch.tall_skinny_auto(nbig, nsmall, a.device))


def _tall_project_dense(a: torch.Tensor, mat: torch.Tensor, n_small: int,
                        own_dtype: bool = False):
    small_shape = tuple(a.shape[a.dim() - n_small:])
    small_axes = list(range(a.dim() - n_small, a.dim()))
    p = mat.reshape(small_shape + (mat.shape[1],))
    return torch.tensordot(a, p, dims=(small_axes, list(range(n_small))))


def _tall_project_nbig(a: torch.Tensor, n_small: int) -> int:
    return math.prod(a.shape[: a.dim() - n_small])


def _tall_project_kernel(a: torch.Tensor, mat: torch.Tensor, n_small: int,
                        own_dtype: bool = False):
    big_shape = tuple(a.shape[: a.dim() - n_small])
    out = planar_matmul(a.reshape(math.prod(big_shape), mat.shape[0]), mat,
                        compute=None if own_dtype
                        else _dispatch.kernel_compute())
    return out.reshape(big_shape + (mat.shape[1],))


_dispatch.register_kernel(
    "tall_apply", kernel=_tall_project_kernel, dense=_tall_project_dense,
    supported=lambda a, mat, n_small, own_dtype=False:
        _dispatch.dtype_supported(a.dtype, mat.dtype),
    auto=lambda a, mat, n_small, own_dtype=False:
        _dispatch.tall_skinny_auto(_tall_project_nbig(a, n_small),
                                   max(mat.shape), a.device))


def tall_project(a: torch.Tensor, mat: torch.Tensor, n_small: int,
                 own_dtype: bool = False) -> torch.Tensor:
    """Contract ``a``'s trailing ``n_small`` axes with the 2D matrix ``mat``
    (``(nsmall, q)``); the result has shape ``big_shape + (q,)``.  On the
    kernel the multiplicands are the kernel compute dtype's
    (:func:`repro_torch.kernels.dispatch.set_kernel_compute`), or with
    ``own_dtype`` the operands' own."""
    return _dispatch.dispatch("tall_apply", a, mat, n_small,
                              own_dtype=own_dtype)


def gram_qr(a: torch.Tensor, n_small: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """QR-equivalent factorization A = Q @ R via the Gram trick (Alg. 5).

    ``a`` maps its *last* ``n_small`` modes (small space) to its leading
    modes (big space).  Returns ``q`` with the shape of ``a`` (isometric
    over the big modes on the row space of A) and ``r`` of shape
    ``small + small`` with ``a == q . r``."""
    big_shape = tuple(a.shape[: a.dim() - n_small])
    small_shape = tuple(a.shape[a.dim() - n_small:])
    nbig, nsmall = math.prod(big_shape), math.prod(small_shape)
    big_axes = tuple(range(a.dim() - n_small))
    # a Gram of bf16 multiplicands (the mixed policy on the kernel) resolves
    # its eigenvalues to bf16's precision only, so they are clamped at
    # bf16's eps: at the operand's, its noise directions put a 4x4 TFI
    # norm 2.4e4 off the exact one (tools/precision_drivers.py --ablations)
    bf16 = (_dispatch.kernel_compute() == "bfloat16"
            and _dispatch.routes_to_kernel("gram", a, big_axes, nbig, nsmall))
    g_mat = _dispatch.dispatch("gram", a, big_axes, nbig, nsmall)
    # eigh of G / max|G|: the same eigenvectors, eigenvalues scaled back.
    # cuSOLVER's heevd fails to converge on complex64 Grams whose entries
    # all lie far below 1 (max |G| of 1e-14 to 1e-18, measured on the H100
    # in one-layer amplitude contractions), where LAPACK does not.
    scale = g_mat.abs().max()
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    lam, x = eigh_reg(g_mat / scale)
    lam = lam * scale
    # per-dtype clamp relative to the largest eigenvalue (floor 1.0): the
    # noise directions of a rank-deficient A get sqrt(eps) instead of 0
    eps = _eps_for(torch.bfloat16 if bf16 else a.dtype) * torch.clamp(
        lam.abs().max(), min=1.0)
    lam = torch.maximum(lam, eps)
    sqrt_lam = torch.sqrt(lam)
    r_mat = sqrt_lam[:, None] * x.mH                 # R = sqrt(L) X^H
    p_mat = x / sqrt_lam[None, :]                    # P = R^{-1} = X L^{-1/2}
    # Q = A P in the operand's own multiplicands: P amplifies a direction
    # of eigenvalue lam by sqrt(lam_max / lam), and would amplify bf16's
    # rounding of A and P as much (in bf16 here that 4x4 TFI norm lies
    # 2.7e-2 off, against 2.4e-3)
    q = tall_project(a, p_mat, n_small, own_dtype=True).reshape(a.shape)
    r = r_mat.reshape(small_shape + small_shape)
    return q, r


def orthogonalize_cols(t: torch.Tensor) -> torch.Tensor:
    """Orthonormalize a sketch ``(*dims, k)`` over its last axis (the
    ``orthogonalize`` inside randomized SVD, paper Alg. 4)."""
    q, _ = gram_qr(t, 1)
    return q


def reshape_qr(a: torch.Tensor, n_small: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: matricize + LAPACK QR (the approach Alg. 5 avoids); same
    contract as :func:`gram_qr`."""
    big_shape = tuple(a.shape[: a.dim() - n_small])
    small_shape = tuple(a.shape[a.dim() - n_small:])
    nbig, nsmall = math.prod(big_shape), math.prod(small_shape)
    if nbig < nsmall and torch.is_grad_enabled() and a.requires_grad:
        # the reference's jnp.linalg.qr has no derivative here, and torch's
        # gives NaN on the rank-deficient splits of a circuit state
        raise NotImplementedError(
            "reshape_qr: no derivative of a wide QR (big modes "
            f"{nbig} < small modes {nsmall}); use the Gram-QR (gram=True)")
    q_mat, r_mat = torch.linalg.qr(a.reshape(nbig, nsmall), mode="reduced")
    k = q_mat.shape[1]
    if k != nsmall:
        # wide case (nbig < nsmall): zero-pad so the inner bond stays nsmall
        q_mat = torch.cat([q_mat, q_mat.new_zeros(nbig, nsmall - k)], dim=1)
        r_mat = torch.cat([r_mat, r_mat.new_zeros(nsmall - k, nsmall)], dim=0)
    return (q_mat.reshape(big_shape + small_shape),
            r_mat.reshape(small_shape + small_shape))
