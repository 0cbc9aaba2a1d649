"""Gram-matrix kernels: G = A^T A and G = A^H A for a tall operand (paper
Alg. 5 hot spot).

Counterpart of ``repro.kernels.gram``.  On a CUDA tensor :func:`gram` and
:func:`gram_complex` launch the one hand-written kernel of
``csrc/gram.cu`` (real and complex64 instantiations; M split across blocks,
deterministic second pass); on a CPU tensor they use :func:`gram_plain` and
:func:`gram_complex_plain`, the same functions in plain torch.
``compute="bfloat16"`` rounds the multiplicands (for complex A, its real
and imaginary parts) to bf16; accumulation stays f32.
"""
from __future__ import annotations

import torch

from repro_torch import counting
from repro_torch.kernels import build


def _round(x: torch.Tensor, compute) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if compute is not None else x


def gram_plain(a: torch.Tensor, compute=None) -> torch.Tensor:
    """Plain version of :func:`gram`: f32 cast, matmul, cast back."""
    a32 = _round(a.float(), compute)
    return (a32.T @ a32).to(a.dtype)


def gram_complex_plain(a: torch.Tensor, compute=None) -> torch.Tensor:
    """Plain version of :func:`gram_complex`: the reference's planar formula
    in f32, Re G = Re(A)^T Re(A) + Im(A)^T Im(A) and Im G = X - X^T with
    X = Re(A)^T Im(A), with Re G's upper triangle mirrored, so that G is
    exactly Hermitian as the kernel's is."""
    a = a.resolve_conj()
    ar, ai = _round(a.real.float(), compute), _round(a.imag.float(), compute)
    re = ar.T @ ar + ai.T @ ai
    re = torch.triu(re) + torch.triu(re, 1).T
    x = ar.T @ ai
    return torch.complex(re, x - x.T)


def _launch(fn: str, x: torch.Tensor, out_dtype, floats: int, compute,
            name: str) -> torch.Tensor:
    """Run ``csrc/gram.cu`` on row-major ``x`` (M, N) of ``floats`` f32 per
    element: the tile kernel into per-split partials of the packed upper
    triangle, then the fixed-order reduce into G.  The kernel source plans
    the split over M from the card's SM count."""
    m, n = x.shape
    lib = build.library()
    sms = build.sm_count(x.device)
    work = torch.empty((lib.repro_gram_splits(m, n, sms),
                        n * (n + 1) // 2 * floats),
                       dtype=torch.float32, device=x.device)
    g = torch.empty((n, n), dtype=out_dtype, device=x.device)
    err = build.launch(
        getattr(lib, fn), x.device, x.data_ptr(), g.data_ptr(),
        work.data_ptr(), m, n, sms, int(compute is not None))
    build.check(err, name)
    return g


def gram(a: torch.Tensor, *, compute=None) -> torch.Tensor:
    """G = A^T A for real A of shape (M, N) with M >> N."""
    if a.device.type == "cpu":
        return gram_plain(a, compute)
    x, _ = build.f32_matrix(a, "gram")
    g = _launch("repro_gram_f32", x, torch.float32, 1, compute, "gram")
    counting.tick_attr(gram)
    return g.to(a.dtype)


gram.launches = 0


def gram_complex(a: torch.Tensor, *, compute=None) -> torch.Tensor:
    """G = A^H A for complex64 A of shape (M, N) with M >> N, exactly
    Hermitian (Re G symmetric, Im G antisymmetric with a zero diagonal).
    On the card one kernel reads A's interleaved storage once; a conj view
    is resolved first, and A must be row-major contiguous."""
    if a.dtype != torch.complex64:
        raise TypeError(f"gram_complex: takes complex64, got {a.dtype}")
    if a.device.type == "cpu":
        return gram_complex_plain(a, compute)
    if a.device.type != "cuda":
        raise ValueError(f"gram_complex: expected a CUDA tensor, got {a.device}")
    if a.dim() != 2 or a.numel() == 0:
        raise ValueError(f"gram_complex: expected a non-empty matrix, got "
                         f"shape {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"gram_complex: expected a row-major contiguous "
                         f"matrix, got strides {a.stride()}")
    a = a.resolve_conj()
    g = _launch("repro_gram_c64", a, torch.complex64, 2, compute,
                "gram_complex")
    counting.tick_attr(gram_complex)
    return g


gram_complex.launches = 0
