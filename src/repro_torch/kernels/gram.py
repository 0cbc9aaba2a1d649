"""Gram-matrix kernel: G = A^T A for a tall operand (paper Alg. 5 hot spot).

Counterpart of ``repro.kernels.gram``.  On a CUDA tensor :func:`gram`
launches the hand-written kernel of ``csrc/gram.cu`` (M split across
blocks, deterministic second pass); on a CPU tensor it uses
:func:`gram_plain`, the same function in plain torch.  ``compute=
"bfloat16"`` rounds the multiplicands to bf16; accumulation stays f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build


def _round(x: torch.Tensor, compute) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if compute is not None else x


def gram_plain(a: torch.Tensor, compute=None) -> torch.Tensor:
    """Plain version of :func:`gram`: f32 cast, matmul, cast back."""
    a32 = _round(a.float(), compute)
    return (a32.T @ a32).to(a.dtype)


def gram(a: torch.Tensor, *, compute=None) -> torch.Tensor:
    """G = A^T A for real A of shape (M, N) with M >> N."""
    if a.device.type == "cpu":
        return gram_plain(a, compute)
    x, _ = build.f32_matrix(a, "gram")
    m, n = x.shape
    ntile = math.ceil(n / 64)
    splits, chunk = build.split_k(m, ntile * (ntile + 1) // 2)
    work = torch.empty((splits, n, n), dtype=torch.float32, device=x.device)
    g = torch.empty((n, n), dtype=torch.float32, device=x.device)
    err = build.library().repro_gram_f32(
        x.data_ptr(), g.data_ptr(), work.data_ptr(), m, n, splits, chunk,
        int(compute is not None), build.stream_ptr(x.device))
    build.check(err, "gram")
    gram.launches += 1
    return g.to(a.dtype)


gram.launches = 0


def gram_complex(a: torch.Tensor, *, compute=None) -> torch.Tensor:
    """G = A^H A for complex A in planar form: two real Grams plus the cross
    term from :func:`~repro_torch.kernels.tiled_matmul.tiled_matmul`.  The
    imaginary part is ``X - X^T`` — exactly antisymmetric by construction,
    matching the Hermiticity of the exact G (``eigh`` reads one triangle)."""
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    a = a.resolve_conj()
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    g_rr = gram(ar, compute=compute)
    g_ii = gram(ai, compute=compute)
    g_ri = tiled_matmul(ar.T, ai, compute=compute)
    return torch.complex(g_rr + g_ii, g_ri - g_ri.T)
