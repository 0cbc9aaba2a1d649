"""Streaming tall-apply kernel: C = A @ B with tall A and a small resident B.

Counterpart of ``repro.kernels.matvec``: the implicit-matvec shape of the
rSVD chain — Gram-QR's reconstitution ``Q = A P`` and the final projections
of ``core/rsvd.randomized_svd``.  On a CUDA tensor :func:`tall_apply`
launches ``csrc/tall_apply.cu`` (B staged whole in shared memory, grid over
row tiles of A); on a CPU tensor it uses :func:`tall_apply_plain`.

Complex operands use the planar trick in ONE real GEMM instead of four:

    [Re C | Im C] = [Re A | Im A] @ [[Re B, Im B], [-Im B, Re B]]
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def tall_apply_plain(a: torch.Tensor, b: torch.Tensor,
                     compute=None) -> torch.Tensor:
    """Plain version of :func:`tall_apply`: f32 cast, matmul, cast back."""
    a32, b32 = a.float(), b.float()
    if compute is not None:
        a32, b32 = a32.to(torch.bfloat16).float(), b32.to(torch.bfloat16).float()
    return (a32 @ b32).to(torch.promote_types(a.dtype, b.dtype))


def tall_apply(a: torch.Tensor, b: torch.Tensor, *,
               compute=None) -> torch.Tensor:
    """C = A @ B for real tall A (M, K) and small resident B (K, N)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tall_apply_plain(a, b, compute)
    x, _ = build.f32_matrix(a, "tall_apply a")
    y, _ = build.f32_matrix(b, "tall_apply b")
    m, k = x.shape
    if y.shape[0] != k:
        raise ValueError(f"tall_apply: inner dims differ, {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    n = y.shape[1]
    lib = build.library()
    smem = lib.repro_tall_apply_smem_bytes(k)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(
            f"tall_apply: B's reduction depth K={k} needs {smem} bytes of "
            f"shared memory for its resident slab, above the "
            f"{build.MAX_SMEM_BYTES} one block may use; use tiled_matmul")
    c = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = lib.repro_tall_apply_f32(x.data_ptr(), y.data_ptr(), c.data_ptr(),
                                   m, k, n, int(compute is not None),
                                   build.stream_ptr(x.device))
    build.check(err, "tall_apply")
    tall_apply.launches += 1
    return c.to(torch.promote_types(a.dtype, b.dtype))


tall_apply.launches = 0


def planar_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  compute=None) -> torch.Tensor:
    """C = A @ B through the tall-apply kernel, complex via one planar GEMM.

    Real operands go straight to :func:`tall_apply`; complex operands are
    planar-decomposed into a single doubled real GEMM (module docstring) —
    the kernel entry point of every complex matricized contraction of the
    zip-up and rSVD sites."""
    if not (a.is_complex() or b.is_complex()):
        return tall_apply(a.contiguous(), b.contiguous(), compute=compute)
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.resolve_conj(), b.resolve_conj()
    ar, ai = (a.real, a.imag) if a.is_complex() else (a, torch.zeros_like(a))
    br, bi = (b.real, b.imag) if b.is_complex() else (b, torch.zeros_like(b))
    n = b.shape[1]
    a2 = torch.cat([ar, ai], dim=1)                               # (M, 2K)
    b2 = torch.cat([torch.cat([br, bi], dim=1),
                    torch.cat([-bi, br], dim=1)], dim=0)          # (2K, 2N)
    c2 = tall_apply(a2, b2, compute=compute)
    return torch.complex(c2[:, :n], c2[:, n:]).to(out_dtype)
