"""Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).

Counterpart of ``repro.kernels.ssd_scan``.  Recurrence per series:
h_t = exp(a_t) h_{t-1} + B_t (x) x_t, y_t = C_t . h_t, with h in R^{N x P}.
On a CUDA tensor :func:`ssd_scan` launches ``csrc/ssd_scan.cu``: for bf16
operands ``ssd_chunk_kernel``, one block per chunk of each series, the
state carried from chunk to chunk by an ordered look-back, every product
on the tensor cores (the three with an f32 operand as three bf16 products
of its exact split, see :func:`ssd_scan_split_plain`); for
f32 operands ``ssd_kernel`` (one block per series, the chunk axis a loop
inside it, plain f32 FMA).  On a CPU tensor it uses :func:`ssd_scan_plain`,
the same chunked computation in plain torch.  Both can return the final
state, which prefill hands to decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import counting
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import split_bf16x3

DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 128
MAX_HEAD_DIM = 64
MAX_STATE = 128


def _chunks(x, b, c, a, chunk):
    """The inputs in f32, padded to whole chunks: (xc (BH, NC, T, P), bc
    and cc (BH, NC, T, N), cum (BH, NC, T) inclusive prefix sums of a,
    lmat (BH, NC, T, T) the decay mask exp(cum_i - cum_j) where i >= j)."""
    bh, length, p = x.shape
    n = b.shape[-1]
    pad = (-length) % chunk
    xf, bf, cf, af = (t.float() for t in (x, b, c, a))
    if pad:
        xf, bf, cf = (F.pad(t, (0, 0, 0, pad)) for t in (xf, bf, cf))
        af = F.pad(af, (0, pad))
    nc = xf.shape[1] // chunk
    cum = af.reshape(bh, nc, chunk).cumsum(dim=-1)
    ii = torch.arange(chunk, device=x.device)
    lower = ii[:, None] >= ii[None, :]
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    lmat = torch.where(lower, decay, torch.zeros((), device=x.device))
    return (xf.reshape(bh, nc, chunk, p), bf.reshape(bh, nc, chunk, n),
            cf.reshape(bh, nc, chunk, n), cum, lmat)


def _carry(h_chunk, total):
    """The chunk-to-chunk state carry: (incoming states (BH, NC, N, P),
    final state (BH, N, P)) from each chunk's own contribution and total
    log-decay (BH, NC)."""
    h = torch.zeros_like(h_chunk[:, 0])
    h_in = []
    for i in range(h_chunk.shape[1]):
        h_in.append(h)
        h = torch.exp(total[:, i])[:, None, None] * h + h_chunk[:, i]
    return torch.stack(h_in, dim=1), h


def ssd_scan_plain(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   a: torch.Tensor, *, chunk: int = 128,
                   return_state: bool = False):
    """Plain version of :func:`ssd_scan`: all chunks' intra-chunk products at
    once, then the chunk-to-chunk state carry as a loop.  f32 inside; y in
    x's dtype; the final state (BH, N, P) in f32."""
    bh, length, p = x.shape
    xc, bc, cc, cum, lmat = _chunks(x, b, c, a, chunk)
    total = cum[..., -1]                                   # (BH, NC)
    smat = torch.einsum("zcin,zcjn->zcij", cc, bc) * lmat
    y = smat @ xc                                          # intra-chunk
    w_in = torch.exp(total[..., None] - cum)[..., None] * bc
    h_in, h = _carry(torch.einsum("zcjn,zcjp->zcnp", w_in, xc), total)
    y = y + (cc * torch.exp(cum)[..., None]) @ h_in
    y = y.reshape(bh, -1, p)[:, :length].to(x.dtype)
    return (y, h) if return_state else y


def ssd_scan_split_plain(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         a: torch.Tensor, *, chunk: int = 128,
                         return_state: bool = False, pieces: int = 3):
    """:func:`ssd_scan_plain` with each of its three f32 operands (the
    decayed scores (C B^T) * L, the decay-weighted B and the incoming
    state h_in) taken as the first ``pieces`` of :func:`split_bf16x3`, each
    times its bf16 input in f32, and exp(cum) applied to C h_in afterwards.
    ``pieces=3`` is the bf16 kernels' arithmetic (the operands exact);
    ``pieces=1`` rounds them to bf16, which the f32 contract forbids."""
    def times(f32_operand, equation, other):
        return sum(torch.einsum(equation, piece.float(), other)
                   for piece in split_bf16x3(f32_operand)[:pieces])

    bh, length, p = x.shape
    xc, bc, cc, cum, lmat = _chunks(x, b, c, a, chunk)
    total = cum[..., -1]
    smat = torch.einsum("zcin,zcjn->zcij", cc, bc) * lmat
    y = times(smat, "zcij,zcjp->zcip", xc)
    w_in = torch.exp(total[..., None] - cum)[..., None] * bc
    h_in, h = _carry(times(w_in, "zcjn,zcjp->zcnp", xc), total)
    y = y + torch.exp(cum)[..., None] * times(h_in, "zcnp,zcin->zcip", cc)
    y = y.reshape(bh, -1, p)[:, :length].to(x.dtype)
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
    if x.dtype == torch.bfloat16:
        # the bf16 kernels copy 16-byte rows with cp.async
        if x.shape[2] % 8 or b.shape[2] % 8:
            raise ValueError(f"ssd_scan: the bf16 kernels take P and N that "
                             f"are multiples of 8, got {x.shape[2]}, "
                             f"{b.shape[2]}")
        for name, t in (("x", x), ("b", b), ("c", c)):
            if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:2]):
                raise ValueError(
                    f"ssd_scan {name}: the bf16 kernels take a 16-byte "
                    f"aligned pointer and (series, step) strides that are "
                    f"multiples of 8 elements, got strides {t.stride()}")


def _smem_bytes(p: int, n: int, chunk: int, dtype) -> int:
    """Shared memory the largest block needs, from the library's own size
    query for the kernels that take ``dtype``."""
    lib = build.library()
    if dtype == torch.bfloat16:
        return lib.repro_ssd_chunked_smem_bytes(p, n, chunk)
    return lib.repro_ssd_scan_smem_bytes(p, n, chunk)


def fits(p: int, n: int, chunk: int, dtype=torch.float32) -> bool:
    """True iff the kernels for ``dtype`` take head dimension ``p``, state
    ``n`` and ``chunk``: :func:`ssd_scan`'s limits (for bf16 also P and N
    multiples of 8), and the shared memory the library's own size query
    asks for within one block's.  The ``ssd`` site's ``auto`` mode routes
    anything else to the dense form."""
    if p > MAX_HEAD_DIM or n > MAX_STATE or chunk % 16 != 0 \
            or not 16 <= chunk <= MAX_CHUNK:
        return False
    if dtype == torch.bfloat16 and (p % 8 or n % 8):
        return False
    return _smem_bytes(p, n, chunk, dtype) <= build.MAX_SMEM_BYTES


def ssd_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             a: torch.Tensor, *, chunk: int = 128, return_state: bool = False):
    """SSD scan over (BH, L, P) inputs with (BH, L, N) B/C and (BH, L) f32
    log-decay ``a`` (``dt * A``, <= 0); ``x`` is the dt-scaled input.

    Returns y (BH, L, P) in x's dtype, and with ``return_state`` also the
    final state (BH, N, P) in f32.  A ragged last chunk needs no padding;
    operands are read through their (series, step) strides.  bf16 launches
    ``ssd_chunk_kernel``, one block per chunk of each series, with an f32
    scratch of (BH, NC - 1, N, P) states between chunks (NC the number of
    chunks) and BH NC + 1 int32 flags; f32 launches ``ssd_kernel``.
    Neither falls back to the plain version."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, b, c, a, chunk=chunk,
                              return_state=return_state)
    _check(x, b, c, a, chunk)
    bh, length, p = x.shape
    n = b.shape[2]
    smem = _smem_bytes(p, n, chunk, x.dtype)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk} need {smem} "
                         f"bytes of shared memory, above the "
                         f"{build.MAX_SMEM_BYTES} one block may use")
    y = torch.empty((bh, length, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
             if return_state else None)
    args = [x.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
            y.data_ptr(), state.data_ptr() if return_state else None]
    if x.dtype == torch.bfloat16:
        nc = -(-length // chunk)
        states = torch.empty((bh, nc - 1, n, p), dtype=torch.float32,
                             device=x.device)
        flags = torch.empty(bh * nc + 1, dtype=torch.int32, device=x.device)
        args += [states.data_ptr(), flags.data_ptr()]
    args += [bh, length, p, n, chunk]
    args += [s for t in (x, b, c, a) for s in t.stride()[:2]]
    launch = (build.library().repro_ssd_scan_bf16 if x.dtype == torch.bfloat16
              else build.library().repro_ssd_scan)
    build.check(build.launch(launch, x.device, *args), "ssd_scan")
    counting.tick_attr(ssd_scan)
    return (y, state) if return_state else y


ssd_scan.launches = 0
