"""Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).

Counterpart of ``repro.kernels.ssd_scan``.  Recurrence per series:
h_t = exp(a_t) h_{t-1} + B_t (x) x_t, y_t = C_t . h_t, with h in R^{N x P}.
On a CUDA tensor :func:`ssd_scan` launches ``csrc/ssd_scan.cu`` (one block
per series, the chunk axis a loop inside it, the state in shared memory);
on a CPU tensor it uses :func:`ssd_scan_plain`, the same chunked
computation in plain torch.  Both can return the final state, which
prefill hands to decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 128
MAX_HEAD_DIM = 64
MAX_STATE = 128


def ssd_scan_plain(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   a: torch.Tensor, *, chunk: int = 128,
                   return_state: bool = False):
    """Plain version of :func:`ssd_scan`: all chunks' intra-chunk products at
    once, then the chunk-to-chunk state carry as a loop.  f32 inside; y in
    x's dtype; the final state (BH, N, P) in f32."""
    bh, length, p = x.shape
    n = b.shape[-1]
    pad = (-length) % chunk
    xf, bf, cf, af = (t.float() for t in (x, b, c, a))
    if pad:
        xf, bf, cf = (F.pad(t, (0, 0, 0, pad)) for t in (xf, bf, cf))
        af = F.pad(af, (0, pad))
    nc = xf.shape[1] // chunk
    xc = xf.reshape(bh, nc, chunk, p)
    bc = bf.reshape(bh, nc, chunk, n)
    cc = cf.reshape(bh, nc, chunk, n)
    cum = af.reshape(bh, nc, chunk).cumsum(dim=-1)
    total = cum[..., -1]                                   # (BH, NC)
    ii = torch.arange(chunk, device=x.device)
    lower = ii[:, None] >= ii[None, :]
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    lmat = torch.where(lower, decay, torch.zeros((), device=x.device))
    smat = torch.einsum("zcin,zcjn->zcij", cc, bc) * lmat
    y = smat @ xc                                          # intra-chunk
    w_in = torch.exp(total[..., None] - cum)[..., None] * bc
    h_chunk = torch.einsum("zcjn,zcjp->zcnp", w_in, xc)
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    h_in = []
    for i in range(nc):                                    # incoming states
        h_in.append(h)
        h = torch.exp(total[:, i])[:, None, None] * h + h_chunk[:, i]
    y = y + (cc * torch.exp(cum)[..., None]) @ torch.stack(h_in, dim=1)
    y = y.reshape(bh, nc * chunk, p)[:, :length].to(x.dtype)
    return (y, h) if return_state else y


def _check(x, b, c, a, chunk) -> None:
    for name, t in (("x", x), ("b", b), ("c", c), ("a", a)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan {name}: expected a CUDA tensor, got "
                             f"{t.device}")
        if t.numel() == 0 or t.stride(-1) != 1:
            raise ValueError(f"ssd_scan {name}: expected a non-empty tensor "
                             f"with a unit last stride, got shape "
                             f"{tuple(t.shape)}, strides {t.stride()}")
    if not (x.dtype == b.dtype == c.dtype) or x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: x, b, c must all be float32 or all "
                        f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a (log-decay) must be float32, got {a.dtype}")
    if x.dim() != 3 or b.dim() != 3 or b.shape != c.shape or a.dim() != 2 \
            or b.shape[:2] != x.shape[:2] or a.shape != x.shape[:2]:
        raise ValueError(f"ssd_scan: expected x (BH, L, P), b and c (BH, L, N), "
                         f"a (BH, L); got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(a.shape)}")
    if x.shape[2] > MAX_HEAD_DIM or b.shape[2] > MAX_STATE:
        raise ValueError(f"ssd_scan: P={x.shape[2]} or N={b.shape[2]} exceeds "
                         f"the kernel's {MAX_HEAD_DIM} / {MAX_STATE}")
    if chunk % 16 != 0 or not 16 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} must be a multiple of 16 "
                         f"from 16 to {MAX_CHUNK}")


def fits(p: int, n: int, chunk: int) -> bool:
    """True iff the kernel takes head dimension ``p``, state ``n`` and
    ``chunk``: :func:`ssd_scan`'s limits, and the shared memory the
    library's own size query asks for within one block's.  The ``ssd``
    site's ``auto`` mode routes anything else to the dense form."""
    if p > MAX_HEAD_DIM or n > MAX_STATE or chunk % 16 != 0 \
            or not 16 <= chunk <= MAX_CHUNK:
        return False
    smem = build.library().repro_ssd_scan_smem_bytes(p, n, chunk)
    return smem <= build.MAX_SMEM_BYTES


def ssd_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             a: torch.Tensor, *, chunk: int = 128, return_state: bool = False):
    """SSD scan over (BH, L, P) inputs with (BH, L, N) B/C and (BH, L) f32
    log-decay ``a`` (``dt * A``, <= 0); ``x`` is the dt-scaled input.

    Returns y (BH, L, P) in x's dtype, and with ``return_state`` also the
    final state (BH, N, P) in f32.  A ragged last chunk needs no padding."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, b, c, a, chunk=chunk,
                              return_state=return_state)
    _check(x, b, c, a, chunk)
    bh, length, p = x.shape
    n = b.shape[2]
    lib = build.library()
    smem = lib.repro_ssd_scan_smem_bytes(p, n, chunk)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk} need {smem} "
                         f"bytes of shared memory, above the "
                         f"{build.MAX_SMEM_BYTES} one block may use")
    y = torch.empty((bh, length, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
             if return_state else None)
    strides = [s for t in (x, b, c, a) for s in t.stride()[:2]]
    err = lib.repro_ssd_scan(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), y.data_ptr(),
        state.data_ptr() if return_state else None, bh, length, p, n, chunk,
        int(x.dtype == torch.bfloat16), *strides, build.stream_ptr(x.device))
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
