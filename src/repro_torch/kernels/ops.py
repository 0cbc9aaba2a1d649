"""Entry points of the hand-written kernels, as ``repro.kernels.ops`` has
them: ``matmul``, ``gram``, ``attention`` and ``ssd``.

``matmul`` and ``gram`` follow the reference's ``use_pallas`` switch as
``use_kernel``: ``None`` means "the operand is on CUDA", as the reference's
``None`` means "on a TPU".  The kernel route is :func:`tiled_matmul` for
``matmul``, and :func:`gram` or :func:`gram_complex`, chosen by dtype, for
``gram``; the plain route is their plain versions.  A kernel wrapper given
a CPU tensor runs its plain version too, and counts no launch.

Neither kernel has a backward: when autograd would record the call (grad
enabled, an operand that requires grad), ``use_kernel=None`` runs the plain
version and ticks ``dense_ops_<op>_grad_calls`` in ``dispatch_stats()``,
and ``use_kernel=True`` raises, before the kernel wrapper's CPU branch, as
a dispatch site does (:func:`repro_torch.kernels.dispatch.grad_route`).

``attention`` and ``ssd`` are sites of :mod:`repro_torch.kernels.dispatch`.
The kernel form is the hand-written CUDA kernel (its plain version on a CPU
tensor), the dense form is the plain version.  Only float32 and bfloat16
operands reach a kernel (the hard gate); ``auto`` picks the kernel when the
operand is on CUDA, as the reference picks Pallas on a TPU, and for ``ssd``
only at a shape the kernel takes (``ssd_scan.fits``).  Launches are counted
as ``kernel_attention_calls`` / ``kernel_ssd_calls``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels import gram as _gram
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import DTYPES, fits, ssd_scan, ssd_scan_plain
from repro_torch.kernels.tiled_matmul import tiled_matmul, tiled_matmul_plain


def matmul(a: torch.Tensor, b: torch.Tensor, use_kernel: bool = None,
           **kw) -> torch.Tensor:
    """C = A @ B with f32 accumulation (``compute="bfloat16"`` rounds the
    multiplicands)."""
    if use_kernel is not False and dispatch.grad_route(
            "ops_matmul", use_kernel is True, a, b):
        use_kernel = False
    if use_kernel is None:
        use_kernel = a.device.type == "cuda"
    return (tiled_matmul if use_kernel else tiled_matmul_plain)(a, b, **kw)


def gram(a: torch.Tensor, use_kernel: bool = None, **kw) -> torch.Tensor:
    """G = A^T A of real A, G = A^H A of complex64 A."""
    if use_kernel is not False and dispatch.grad_route(
            "ops_gram", use_kernel is True, a):
        use_kernel = False
    if use_kernel is None:
        use_kernel = a.device.type == "cuda"
    if a.is_complex():
        fn = _gram.gram_complex if use_kernel else _gram.gram_complex_plain
    else:
        fn = _gram.gram if use_kernel else _gram.gram_plain
    return fn(a, **kw)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Attention over (B, Hq, S, D) queries, (B, Hkv, Sk, D) keys/values."""
    return dispatch.dispatch("attention", q, k, v, causal=causal)


def ssd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
        *, chunk: int = 128, return_state: bool = False):
    """SSD scan over (BH, L, P) x, (BH, L, N) b/c, (BH, L) log-decay a."""
    return dispatch.dispatch("ssd", x, b, c, a, chunk=chunk,
                             return_state=return_state)


def _supported(*tensors, **_) -> bool:
    return all(t.dtype in DTYPES for t in tensors[:3])


def _on_cuda(q, *_, **__) -> bool:
    return q.device.type == "cuda"


def _ssd_auto(x, b, c, a, *, chunk: int = 128, **_) -> bool:
    """On CUDA, and at a shape the kernel takes: a routing decision made
    before the call, so what the kernel refuses runs dense."""
    return x.device.type == "cuda" and fits(x.shape[2], b.shape[2], chunk,
                                            x.dtype)


dispatch.register_kernel("attention", kernel=flash_attention,
                         dense=flash_attention_plain, supported=_supported,
                         auto=_on_cuda)
dispatch.register_kernel("ssd", kernel=ssd_scan, dense=ssd_scan_plain,
                         supported=_supported, auto=_ssd_auto)
