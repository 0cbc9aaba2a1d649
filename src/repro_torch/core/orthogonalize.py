"""Reshape-avoiding orthogonalization via Gram matrices (paper Alg. 5).

Counterpart of ``repro.core.orthogonalize``.  ``gram_qr`` forms the small
Gram matrix ``G = A^H A`` with a contraction over the big modes,
eigendecomposes G, and reconstitutes the isometry ``Q = A P`` with one more
GEMM.  Two kernel-dispatch sites (:mod:`repro_torch.kernels.dispatch`):

* ``"gram"``       — G = A^H A: the streaming-Gram kernel
  (``src/repro_torch/kernels/gram.py``; complex through ``gram_complex``);
* ``"tall_apply"`` — Q = A P and the final rSVD projections: the
  tall-apply kernel (``src/repro_torch/kernels/matvec.py``).

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


def _gram_dense(a: torch.Tensor, big_axes, nbig: int, nsmall: int):
    g = torch.tensordot(a.conj(), a, dims=(list(big_axes), list(big_axes)))
    return g.reshape(nsmall, nsmall)


def _gram_kernel(a: torch.Tensor, big_axes, nbig: int, nsmall: int):
    mat = a.reshape(nbig, nsmall)
    compute = _dispatch.kernel_compute()
    if a.is_complex():
        return gram_complex(mat, compute=compute)
    return gram(mat.contiguous(), compute=compute)


_dispatch.register_kernel(
    "gram", kernel=_gram_kernel, dense=_gram_dense,
    supported=lambda a, big_axes, nbig, nsmall:
        _dispatch.dtype_supported(a.dtype),
    auto=lambda a, big_axes, nbig, nsmall:
        _dispatch.tall_skinny_auto(nbig, nsmall, a.device))


def _tall_project_dense(a: torch.Tensor, mat: torch.Tensor, n_small: int):
    small_shape = tuple(a.shape[a.dim() - n_small:])
    small_axes = list(range(a.dim() - n_small, a.dim()))
    p = mat.reshape(small_shape + (mat.shape[1],))
    return torch.tensordot(a, p, dims=(small_axes, list(range(n_small))))


def _tall_project_nbig(a: torch.Tensor, n_small: int) -> int:
    return math.prod(a.shape[: a.dim() - n_small])


def _tall_project_kernel(a: torch.Tensor, mat: torch.Tensor, n_small: int):
    big_shape = tuple(a.shape[: a.dim() - n_small])
    out = planar_matmul(a.reshape(math.prod(big_shape), mat.shape[0]), mat,
                        compute=_dispatch.kernel_compute())
    return out.reshape(big_shape + (mat.shape[1],))


_dispatch.register_kernel(
    "tall_apply", kernel=_tall_project_kernel, dense=_tall_project_dense,
    supported=lambda a, mat, n_small:
        _dispatch.dtype_supported(a.dtype, mat.dtype),
    auto=lambda a, mat, n_small:
        _dispatch.tall_skinny_auto(_tall_project_nbig(a, n_small),
                                   max(mat.shape), a.device))


def tall_project(a: torch.Tensor, mat: torch.Tensor,
                 n_small: int) -> torch.Tensor:
    """Contract ``a``'s trailing ``n_small`` axes with the 2D matrix ``mat``
    (``(nsmall, q)``); the result has shape ``big_shape + (q,)``."""
    return _dispatch.dispatch("tall_apply", a, mat, n_small)


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
    eps = _eps_for(a.dtype) * torch.clamp(lam.abs().max(), min=1.0)
    lam = torch.maximum(lam, eps)
    sqrt_lam = torch.sqrt(lam)
    r_mat = sqrt_lam[:, None] * x.mH                 # R = sqrt(L) X^H
    p_mat = x / sqrt_lam[None, :]                    # P = R^{-1} = X L^{-1/2}
    q = tall_project(a, p_mat, n_small).reshape(a.shape)
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
    q_mat, r_mat = torch.linalg.qr(a.reshape(nbig, nsmall), mode="reduced")
    k = q_mat.shape[1]
    if k != nsmall:
        # wide case (nbig < nsmall): zero-pad so the inner bond stays nsmall
        q_mat = torch.cat([q_mat, q_mat.new_zeros(nbig, nsmall - k)], dim=1)
        r_mat = torch.cat([r_mat, r_mat.new_zeros(nsmall - k, nsmall)], dim=0)
    return (q_mat.reshape(big_shape + small_shape),
            r_mat.reshape(small_shape + small_shape))
