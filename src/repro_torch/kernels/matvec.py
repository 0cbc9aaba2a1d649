"""Tall-apply kernel: C = A @ B with a tall A and a small B, f32 or complex64.

Counterpart of ``repro.kernels.matvec``: the implicit-matvec shape of the
rSVD chain — Gram-QR's reconstitution ``Q = A P`` and the final projections
of ``core/rsvd.randomized_svd``.  On a CUDA tensor :func:`tall_apply` (f32)
and :func:`tall_apply_complex` (complex64) launch the one hand-written
kernel of ``csrc/tall_apply.cu``: it reads A in place once (a conj view
too), B through its strides and conj bit, stages B over K (so K has no
limit), and writes C directly.  On a CPU tensor they use
:func:`tall_apply_plain` and :func:`tall_apply_complex_plain`.
:func:`planar_matmul`, the reference's entry point, routes to them.

The reference computes a complex product with the planar trick, ONE real
GEMM instead of four:

    [Re C | Im C] = [Re A | Im A] @ [[Re B, Im B], [-Im B, Re B]]

which :func:`tall_apply_complex_plain` keeps as the plain version.
``compute="bfloat16"`` rounds the multiplicands (Re and Im separately) to
bf16; accumulation stays f32.
"""
from __future__ import annotations

import torch

from repro_torch import counting
from repro_torch.kernels import build


def tall_apply_plain(a: torch.Tensor, b: torch.Tensor,
                     compute=None) -> torch.Tensor:
    """Plain version of :func:`tall_apply`: f32 cast, matmul, cast back."""
    a32, b32 = a.float(), b.float()
    if compute is not None:
        a32, b32 = a32.to(torch.bfloat16).float(), b32.to(torch.bfloat16).float()
    return (a32 @ b32).to(torch.promote_types(a.dtype, b.dtype))


def tall_apply_complex_plain(a: torch.Tensor, b: torch.Tensor,
                             compute=None) -> torch.Tensor:
    """Plain version of :func:`tall_apply_complex`: the reference's planar
    formula (module docstring) over :func:`tall_apply_plain`."""
    a, b = a.resolve_conj(), b.resolve_conj()
    n = b.shape[1]
    a2 = torch.cat([a.real, a.imag], dim=1)                       # (M, 2K)
    b2 = torch.cat([torch.cat([b.real, b.imag], dim=1),
                    torch.cat([-b.imag, b.real], dim=1)], dim=0)  # (2K, 2N)
    c2 = tall_apply_plain(a2, b2, compute)
    return torch.complex(c2[:, :n], c2[:, n:])


def _launch(fn: str, a: torch.Tensor, b: torch.Tensor, compute,
            *flags) -> torch.Tensor:
    """Check the operands and run ``csrc/tall_apply.cu``: A (M, K) with unit
    column stride, B (K, N) with any strides, C (M, N) row-major of A's
    dtype.  The kernel sizes its grid from the card's SM count."""
    for x, what in ((a, "a"), (b, "b")):
        if x.device.type != "cuda":
            raise ValueError(f"{fn} {what}: expected a CUDA tensor, got "
                             f"{x.device}")
        if x.dim() != 2 or x.numel() == 0:
            raise ValueError(f"{fn} {what}: expected a non-empty matrix, got "
                             f"shape {tuple(x.shape)}")
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"{fn}: inner dims differ, {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.stride(1) != 1 and k > 1:
        raise ValueError(f"{fn} a: expected a unit column stride, got strides "
                         f"{a.stride()}")
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = build.launch(
        getattr(build.library(), fn), a.device, a.data_ptr(), b.data_ptr(),
        c.data_ptr(), m, k, n, a.stride(0), *b.stride(),
        build.sm_count(a.device), int(compute is not None), *flags)
    build.check(err, fn)
    return c


def tall_apply(a: torch.Tensor, b: torch.Tensor, *,
               compute=None) -> torch.Tensor:
    """C = A @ B for real tall A (M, K) and small B (K, N), f32 or bf16 (bf16
    is widened to f32, exactly).  On the card A needs a unit column stride;
    B may have any strides."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tall_apply_plain(a, b, compute)
    x, y = (t.float() if t.dtype == torch.bfloat16 else t for t in (a, b))
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"tall_apply: the kernel takes float32 or bfloat16, "
                        f"got {a.dtype}, {b.dtype}")
    c = _launch("repro_tall_apply_f32", x, y, compute)
    counting.tick_attr(tall_apply)
    return c.to(torch.promote_types(a.dtype, b.dtype))


tall_apply.launches = 0


def tall_apply_complex(a: torch.Tensor, b: torch.Tensor, *,
                       compute=None) -> torch.Tensor:
    """C = A @ B for complex64 tall A (M, K) and small B (K, N).  On the card
    one kernel reads A's interleaved storage in place (a conj view too;
    unit column stride, any row stride) and B through its strides and conj
    bit, and writes C as complex64: one launch, one allocation."""
    if a.dtype != torch.complex64 or b.dtype != torch.complex64:
        raise TypeError(f"tall_apply_complex: takes complex64, got {a.dtype}, "
                        f"{b.dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tall_apply_complex_plain(a, b, compute)
    # conj(A) B = conj(A conj(B)): the kernel conjugates B and C as asked
    conj_a = a.is_conj()
    c = _launch("repro_tall_apply_c64", a, b, compute,
                int(conj_a != b.is_conj()), int(conj_a))
    counting.tick_attr(tall_apply_complex)
    return c


tall_apply_complex.launches = 0


def planar_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  compute=None) -> torch.Tensor:
    """C = A @ B through the tall-apply kernel: the counterpart of the
    reference's ``planar_matmul``, the kernel entry point of every
    matricized contraction of the zip-up and rSVD sites.  Real operands go
    to :func:`tall_apply`, complex ones to :func:`tall_apply_complex` in
    complex64 (the real operand of a mixed product is promoted; f32
    accumulation, as in the reference); on the card a complex call is one
    launch that reads A in place."""
    if a.stride(-1) != 1 and a.shape[-1] > 1:
        a = a.contiguous()
    if not (a.is_complex() or b.is_complex()):
        return tall_apply(a, b, compute=compute)
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = (x.to(torch.complex64) for x in (a, b))
    return tall_apply_complex(a, b, compute=compute).to(out_dtype)
