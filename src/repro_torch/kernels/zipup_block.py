"""Zip-up first-column and pair-merge einsums, dense and kernel forms.

Counterpart of ``repro.kernels.zipup_block``.  Each site is a (chain of)
matricized GEMM(s): the kernel form runs them through
:func:`~repro_torch.kernels.matvec.planar_matmul` (the hand-written
tall-apply kernel on the card), the dense form is the plain einsum.
Dispatch goes through :mod:`repro_torch.kernels.dispatch` (sites
``zipup_first_onelayer`` / ``zipup_first_twolayer`` / ``pair_merge``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.matvec import planar_matmul


# ---------------------------------------------------------------------------
# One-layer first column: S_0 (b,f,g) x O_0 (f,c,h,k) -> (b,c,h,g,k)
# ---------------------------------------------------------------------------

def _first_onelayer_dense(s0, o0):
    return torch.einsum("bfg,fchk->bchgk", s0, o0)


def _first_onelayer_kernel(s0, o0):
    b, f, g = s0.shape
    _, c, h, k = o0.shape
    a_mat = s0.permute(0, 2, 1).reshape(b * g, f)
    b_mat = o0.reshape(f, c * h * k)
    out = planar_matmul(a_mat, b_mat, compute=dispatch.kernel_compute())
    return out.reshape(b, g, c, h, k).permute(0, 2, 3, 1, 4)


def first_column_onelayer(s0: torch.Tensor, o0: torch.Tensor) -> torch.Tensor:
    """Carry init of the one-layer zip-up (``zipup_block`` first column)."""
    return dispatch.dispatch("zipup_first_onelayer", s0, o0)


# ---------------------------------------------------------------------------
# Two-layer first column:
#   S_0 (b,f,F,g) x bra* (p,f,c,h,k) x ket (p,F,C,H,K) -> (b,c,C,h,H,g,k,K)
# ---------------------------------------------------------------------------

def _first_twolayer_dense(s0, tb0, tk0):
    t1 = torch.einsum("bfFg,pfchk->bFgpchk", s0, tb0)
    return torch.einsum("bFgpchk,pFCHK->bcChHgkK", t1, tk0)


def _first_twolayer_kernel(s0, tb0, tk0):
    b, f, F, g = s0.shape
    p, _, c, h, k = tb0.shape
    _, _, C, H, K = tk0.shape
    compute = dispatch.kernel_compute()
    # stage 1 — contract f:  (b F g, f) @ (f, p c h k)
    a1 = s0.permute(0, 2, 3, 1).reshape(b * F * g, f)
    b1 = tb0.permute(1, 0, 2, 3, 4).reshape(f, p * c * h * k)
    t1 = planar_matmul(a1, b1, compute=compute).reshape(b, F, g, p, c, h, k)
    # stage 2 — contract (p, F):  (b g c h k, p F) @ (p F, C H K)
    a2 = t1.permute(0, 2, 4, 5, 6, 3, 1).reshape(b * g * c * h * k, p * F)
    b2 = tk0.reshape(p * F, C * H * K)
    t2 = planar_matmul(a2, b2, compute=compute).reshape(b, g, c, h, k, C, H, K)
    return t2.permute(0, 2, 5, 3, 6, 1, 4, 7)


def first_column_twolayer(s0: torch.Tensor, tb0: torch.Tensor,
                          tk0: torch.Tensor) -> torch.Tensor:
    """Carry init of the two-layer zip-up (``tb0`` pre-conjugated)."""
    return dispatch.dispatch("zipup_first_twolayer", s0, tb0, tk0)


# ---------------------------------------------------------------------------
# First-row pair merge: bra* (p,u,l,d,r) x ket (p,U,L,D,R) -> (l,L,d,D,r,R)
# (u/U are dim 1 on the first row and are summed out)
# ---------------------------------------------------------------------------

def _pair_merge_dense(tb, tk):
    return torch.einsum("puldr,pULDR->lLdDrR", tb, tk)


def _pair_merge_kernel(tb, tk):
    p, u, l, d, r = tb.shape
    _, U, L, D, R = tk.shape
    a_mat = tb.movedim(0, -1).reshape(u * l * d * r, p)
    b_mat = tk.reshape(p, U * L * D * R)
    out = planar_matmul(a_mat, b_mat, compute=dispatch.kernel_compute())
    out = out.reshape(u, l, d, r, U, L, D, R).sum(dim=(0, 4))
    return out.permute(0, 3, 1, 4, 2, 5)             # (l, L, d, D, r, R)


def pair_merge(tb: torch.Tensor, tk: torch.Tensor) -> torch.Tensor:
    """First-row boundary pair merge (``tb`` pre-conjugated)."""
    return dispatch.dispatch("pair_merge", tb, tk)


# ---------------------------------------------------------------------------
# Site registration
# ---------------------------------------------------------------------------

def _supported(*tensors) -> bool:
    return dispatch.dtype_supported(*(t.dtype for t in tensors))


def _auto_onelayer(s0, o0) -> bool:
    b, f, g = s0.shape
    _, c, h, k = o0.shape
    return dispatch.tall_skinny_auto(b * g, max(f, c * h * k), s0.device)


def _auto_twolayer(s0, tb0, tk0) -> bool:
    b, f, F, g = s0.shape
    p, _, c, h, k = tb0.shape
    _, _, C, H, K = tk0.shape
    return dispatch.tall_skinny_auto(b * g * c * h * k,
                                     max(f, p * F, C * H * K), s0.device)


def _auto_pair(tb, tk) -> bool:
    return dispatch.tall_skinny_auto(math.prod(tb.shape[1:]),
                                     math.prod(tk.shape[1:]), tb.device)


dispatch.register_kernel("zipup_first_onelayer",
                         kernel=_first_onelayer_kernel,
                         dense=_first_onelayer_dense,
                         supported=_supported, auto=_auto_onelayer)
dispatch.register_kernel("zipup_first_twolayer",
                         kernel=_first_twolayer_kernel,
                         dense=_first_twolayer_dense,
                         supported=_supported, auto=_auto_twolayer)
dispatch.register_kernel("pair_merge",
                         kernel=_pair_merge_kernel,
                         dense=_pair_merge_dense,
                         supported=_supported, auto=_auto_pair)
