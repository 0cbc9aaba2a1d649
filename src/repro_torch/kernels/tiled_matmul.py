"""General f32 GEMM kernel with a deterministic split over K.

Counterpart of ``repro.kernels.tiled_matmul``.  On a CUDA tensor
:func:`tiled_matmul` launches ``csrc/tiled_matmul.cu`` (72 x 72 block
tiles, a ``cp.async`` ring over K, a fixed-order reduce of the splits'
partials); on a CPU tensor it uses :func:`tiled_matmul_plain`.  ``a`` may
be the transpose of a row-major matrix (``x.T``), which the kernel reads in
place.  Its entry point is :func:`repro_torch.kernels.ops.matmul`, as
``ops.matmul`` is in the reference; no site of the port's main path calls
it (the complex Gram's cross term, its other caller in the reference, is
computed inside :func:`~repro_torch.kernels.gram.gram_complex`).
"""
from __future__ import annotations

import torch

from repro_torch import counting
from repro_torch.kernels import build


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       compute=None) -> torch.Tensor:
    """Plain version of :func:`tiled_matmul`: f32 cast, matmul, cast back."""
    a32, b32 = a.float(), b.float()
    if compute is not None:
        a32, b32 = a32.to(torch.bfloat16).float(), b32.to(torch.bfloat16).float()
    return (a32 @ b32).to(torch.promote_types(a.dtype, b.dtype))


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 compute=None) -> torch.Tensor:
    """C = A @ B for real A (M, K) and B (K, N), f32 accumulation."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return tiled_matmul_plain(a, b, compute)
    x, trans = build.f32_matrix(a, "tiled_matmul a", allow_transposed=True)
    y, _ = build.f32_matrix(b, "tiled_matmul b")
    m, k = x.shape
    if y.shape[0] != k:
        raise ValueError(f"tiled_matmul: inner dims differ, {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    n = y.shape[1]
    lib = build.library()
    sms = build.sm_count(x.device)
    splits = lib.repro_tiled_matmul_splits(m, k, n, sms)
    c = torch.empty((m, n), dtype=torch.float32, device=x.device)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else c)
    err = build.launch(
        lib.repro_tiled_matmul_f32, x.device, x.data_ptr(), y.data_ptr(),
        c.data_ptr(), work.data_ptr(), m, k, n, int(trans), sms,
        int(compute is not None))
    build.check(err, "tiled_matmul")
    counting.tick_attr(tiled_matmul)
    return c.to(torch.promote_types(a.dtype, b.dtype))


tiled_matmul.launches = 0
