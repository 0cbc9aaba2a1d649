"""Zip-up first-column and pair-merge einsums, dense and kernel forms.

Counterpart of ``repro.kernels.zipup_block``.  Each site's kernel form is
one launch of a hand-written kernel of ``csrc/zipup_block.cu`` on a CUDA
tensor: ``zipup_pair_kernel`` for the one-layer first column and the
first-row pair merge (one contraction of two strided operands),
``zipup_chain_kernel`` for the two-layer first column (a chain of two
contractions whose intermediate never reaches device memory).  Each reads
its operands in place through their strides and conj bits and writes its
output contiguous in the final axis order, so the engine's reshape after
the site is a view.  On a CPU tensor the kernel forms run the plain
versions (:func:`first_onelayer_plain`, :func:`first_twolayer_plain`,
:func:`pair_merge_plain`): the same arithmetic as ``einsum`` in f32 or
complex64, with the reference's bf16 rounding points.  The dense form is
the plain einsum.  Dispatch goes through :mod:`repro_torch.kernels.dispatch`
(sites ``zipup_first_onelayer`` / ``zipup_first_twolayer`` /
``pair_merge``).

The f32 contract, as the reference's planar GEMMs keep it: sums in f32;
``compute="bfloat16"`` rounds the real and imaginary parts of every
multiplicand to bf16, in the two-layer chain also the stage-1 result t1,
which the reference hands to its second GEMM as a multiplicand.  A mixed
real/complex call is promoted to complex64, bf16 operands are widened to
f32 exactly, and the output has the operands' promoted dtype.
"""
from __future__ import annotations

import math
from array import array

import torch

from repro_torch import counting
from repro_torch.kernels import build, dispatch

# the dtypes the kernels take (f64 and c128 never reach them: dispatch's
# hard gate, ``dispatch.KERNEL_DTYPES``)
_DTYPES = (torch.float32, torch.bfloat16, torch.complex64)
# flag bits of ``repro_zipup_pair``/``repro_zipup_chain``: operand i is read
# conjugated under _CONJ0 << i
_COMPLEX, _BF16, _CONJ0, _ROUND_T1 = 1, 2, 4, 32


def _promoted(fn, *xs):
    """(working dtype, output dtype) of a call: complex64 if any operand is
    complex, else f32; the output dtype is the operands' promoted one.
    Raises TypeError on a dtype the kernels do not take."""
    for x in xs:
        if x.dtype not in _DTYPES:
            raise TypeError(f"{fn}: the kernel takes float32, bfloat16 or "
                            f"complex64, got {[x.dtype for x in xs]}")
    out = xs[0].dtype
    for x in xs[1:]:
        out = torch.promote_types(out, x.dtype)
    return (torch.complex64 if out.is_complex else torch.float32), out


def _round_bf16(x):
    """``x`` with its real and imaginary parts (or its values) rounded to
    bf16, kept in complex64 (f32)."""
    if x.is_complex():
        x = x.resolve_conj()
        return torch.complex(x.real.to(torch.bfloat16).float(),
                             x.imag.to(torch.bfloat16).float())
    return x.to(torch.bfloat16).float()


def _plain_operands(fn, xs, compute):
    work, out = _promoted(fn, *xs)
    xs = [x.to(work) for x in xs]
    if compute is not None:
        xs = [_round_bf16(x) for x in xs]
    return xs, out


def _cuda_operands(fn, xs):
    """The operands as the kernel reads them: on one CUDA device, in the
    working dtype (a conj view stays one), no negative-bit view."""
    work, out = _promoted(fn, *xs)
    dev = xs[0].device
    for x in xs:
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{fn}: expected CUDA tensors on one device, "
                             f"got {[str(x.device) for x in xs]}")
    return [x if x.dtype == work and not x.is_neg()
            else x.to(work).resolve_neg() for x in xs], work, out


def _launch(fn, lib_fn, xs, out_shape, work, axes, flags):
    """One launch of ``lib_fn`` on the operands ``xs`` into a new
    contiguous output of ``out_shape``; ``axes`` is the int64 argument
    array after ``nd`` (``csrc/zipup_block.cu``).  Returns the output and
    whether the kernel was launched (not for an empty output)."""
    out = torch.empty(out_shape, dtype=work, device=xs[0].device)
    if out.numel() == 0:
        return out, False
    if work == torch.complex64:
        flags |= _COMPLEX
    for i, x in enumerate(xs):
        if x.is_conj():
            flags |= _CONJ0 << i
    args = array("q", (len(out_shape), *out_shape, *axes))
    err = build.launch(
        getattr(build.library(), lib_fn), out.device,
        *(x.data_ptr() for x in xs), out.data_ptr(), args.buffer_info()[0],
        flags)
    build.check(err, fn)
    return out, True


def _shape_error(fn, xs):
    return ValueError(f"{fn}: operand shapes do not contract: "
                      f"{[tuple(x.shape) for x in xs]}")


# ---------------------------------------------------------------------------
# One-layer first column: S_0 (b,f,g) x O_0 (f,c,h,k) -> (b,c,h,g,k)
# ---------------------------------------------------------------------------

def _first_onelayer_dense(s0, o0):
    return torch.einsum("bfg,fchk->bchgk", s0, o0)


def first_onelayer_plain(s0, o0, compute=None):
    """Plain version of the one-layer site's kernel: contiguous
    (b, c, h, g, k) in the promoted dtype."""
    (x, y), out = _plain_operands("first_onelayer_plain", (s0, o0), compute)
    return torch.einsum("bfg,fchk->bchgk", x, y).contiguous().to(out)


def _first_onelayer_kernel(s0, o0):
    """The one-layer site: ``zipup_pair_kernel`` on a CUDA tensor (one
    launch), :func:`first_onelayer_plain` on a CPU tensor."""
    fn = "zipup_first_onelayer"
    if s0.dim() != 3 or o0.dim() != 4 or s0.shape[1] != o0.shape[0]:
        raise _shape_error(fn, (s0, o0))
    compute = dispatch.kernel_compute()
    if s0.device.type == "cpu" and o0.device.type == "cpu":
        return first_onelayer_plain(s0, o0, compute)
    (x, y), work, out_dtype = _cuda_operands(fn, (s0, o0))
    b, f, g = x.shape
    _, c, h, k = y.shape
    xs, ys = x.stride(), y.stride()
    # output (b, c, h, g, k); contracted f, and two unused axes
    out, launched = _launch(
        fn, "repro_zipup_pair", (x, y), (b, c, h, g, k), work,
        (xs[0], 0, 0, xs[2], 0, 0, ys[1], ys[2], 0, ys[3],
         f, 1, 1, xs[1], 0, 0, ys[0], 0, 0),
        0 if compute is None else _BF16)
    counting.tick_attr(_first_onelayer_kernel, n=launched)
    return out if out_dtype == work else out.to(out_dtype)


_first_onelayer_kernel.launches = 0


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


def _rounds_t1(s0, tb0, compute) -> bool:
    """Whether the reference rounds the stage-1 result t1 to bf16: under
    bf16 multiplicands, and where its stage-1 GEMM's result is bf16."""
    return (compute is not None
            or torch.promote_types(s0.dtype, tb0.dtype) == torch.bfloat16)


def first_twolayer_plain(s0, tb0, tk0, compute=None):
    """Plain version of the two-layer site's kernel: t1 = S_0 bra over f,
    rounded to bf16 where the reference rounds it, then t1 ket over
    (p, F); contiguous (b, c, C, h, H, g, k, K) in the promoted dtype."""
    (x, y, z), out = _plain_operands("first_twolayer_plain", (s0, tb0, tk0),
                                     compute)
    t1 = torch.einsum("bfFg,pfchk->bFgpchk", x, y)
    if _rounds_t1(s0, tb0, compute):
        t1 = _round_bf16(t1)
    return torch.einsum("bFgpchk,pFCHK->bcChHgkK", t1, z).contiguous().to(out)


def _first_twolayer_kernel(s0, tb0, tk0):
    """The two-layer site: ``zipup_chain_kernel`` on a CUDA tensor (one
    launch, t1 never in device memory), :func:`first_twolayer_plain` on a
    CPU tensor."""
    fn = "zipup_first_twolayer"
    if (s0.dim() != 4 or tb0.dim() != 5 or tk0.dim() != 5
            or tb0.shape[:2] != (tk0.shape[0], s0.shape[1])
            or tk0.shape[1] != s0.shape[2]):
        raise _shape_error(fn, (s0, tb0, tk0))
    compute = dispatch.kernel_compute()
    if all(t.device.type == "cpu" for t in (s0, tb0, tk0)):
        return first_twolayer_plain(s0, tb0, tk0, compute)
    (x, y, z), work, out_dtype = _cuda_operands(fn, (s0, tb0, tk0))
    b, f, F, g = x.shape
    p, _, c, h, k = y.shape
    _, _, C, H, K = z.shape
    xs, ys, zs = x.stride(), y.stride(), z.stride()
    flags = _BF16 if compute is not None else 0
    if _rounds_t1(s0, tb0, compute):
        flags |= _ROUND_T1
    # output (b, c, C, h, H, g, k, K) with strides into s0, tb0, tk0; the
    # outer sum over (p, F), the inner one over f
    out, launched = _launch(
        fn, "repro_zipup_chain", (x, y, z), (b, c, C, h, H, g, k, K), work,
        (xs[0], 0, 0, 0, 0, xs[3], 0, 0,
         0, ys[2], 0, ys[3], 0, 0, ys[4], 0,
         0, 0, zs[2], 0, zs[3], 0, 0, zs[4],
         p, F, 0, xs[2], ys[0], 0, zs[0], zs[1],
         f, xs[1], ys[1]),
        flags)
    counting.tick_attr(_first_twolayer_kernel, n=launched)
    return out if out_dtype == work else out.to(out_dtype)


_first_twolayer_kernel.launches = 0


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


def pair_merge_plain(tb, tk, compute=None):
    """Plain version of the pair merge's kernel: contiguous
    (l, L, d, D, r, R) in the promoted dtype."""
    (x, y), out = _plain_operands("pair_merge_plain", (tb, tk), compute)
    return torch.einsum("puldr,pULDR->lLdDrR", x, y).contiguous().to(out)


def _pair_merge_kernel(tb, tk):
    """The pair merge: ``zipup_pair_kernel`` on a CUDA tensor (one launch,
    u and U summed as contracted axes that one operand lacks),
    :func:`pair_merge_plain` on a CPU tensor."""
    fn = "pair_merge"
    if tb.dim() != 5 or tk.dim() != 5 or tb.shape[0] != tk.shape[0]:
        raise _shape_error(fn, (tb, tk))
    compute = dispatch.kernel_compute()
    if tb.device.type == "cpu" and tk.device.type == "cpu":
        return pair_merge_plain(tb, tk, compute)
    (x, y), work, out_dtype = _cuda_operands(fn, (tb, tk))
    p, u, l, d, r = x.shape
    _, U, L, D, R = y.shape
    xs, ys = x.stride(), y.stride()
    # output (l, L, d, D, r, R); contracted p, u (tb only), U (tk only)
    out, launched = _launch(
        fn, "repro_zipup_pair", (x, y), (l, L, d, D, r, R), work,
        (xs[2], 0, xs[3], 0, xs[4], 0, 0, ys[2], 0, ys[3], 0, ys[4],
         p, u, U, xs[0], xs[1], 0, ys[0], 0, ys[1]),
        0 if compute is None else _BF16)
    counting.tick_attr(_pair_merge_kernel, n=launched)
    return out if out_dtype == work else out.to(out_dtype)


_pair_merge_kernel.launches = 0


def pair_merge(tb: torch.Tensor, tk: torch.Tensor) -> torch.Tensor:
    """First-row boundary pair merge (``tb`` pre-conjugated)."""
    return dispatch.dispatch("pair_merge", tb, tk)


def kernel_launches() -> dict:
    """Launches of the two kernels of ``csrc/zipup_block.cu`` so far:
    ``zipup_pair`` (the one-layer site and the pair merge) and
    ``zipup_chain`` (the two-layer site)."""
    return {"zipup_pair": (_first_onelayer_kernel.launches
                           + _pair_merge_kernel.launches),
            "zipup_chain": _first_twolayer_kernel.launches}


def reset_kernel_launches() -> None:
    _first_onelayer_kernel.launches = 0
    _pair_merge_kernel.launches = 0
    _first_twolayer_kernel.launches = 0


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
