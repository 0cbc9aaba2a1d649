"""Flash attention (online softmax) for the LM substrate.

Counterpart of ``repro.kernels.flash_attention``.  On a CUDA tensor
:func:`flash_attention` launches ``csrc/flash_attention.cu``: for bf16
operands ``flash_mma_kernel`` (both products on the tensor cores with
``mma.sync``, P V as three bf16 products of the exact split of P, see
:func:`split_bf16x3`), for f32 operands ``flash_kernel`` (plain f32 FMA).
Both take one block per 64-row query tile of one (batch, head), the key
axis a loop inside the block, GQA read in place.  On a CPU tensor it uses
:func:`flash_attention_plain`, the same function in plain torch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import counting
from repro_torch.kernels import build

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          kv_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the whole score matrix at
    once.  Q is scaled by 1/sqrt(D) in its own dtype, as the kernel does;
    scores, softmax and P V are f32; the output is in Q's dtype.  The
    model's one-token decode calls it too, with ``kv_len`` (B,): keys at or
    past ``kv_len[b]`` are masked (the kernel has no such argument)."""
    w = _softmax_weights(q, k, causal, kv_len)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(q.shape).to(q.dtype)


def _softmax_weights(q, k, causal, kv_len=None):
    """The f32 softmax weights P of the plain versions, (B, Hkv, Hq / Hkv,
    S, Sk)."""
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qs = (q * (1.0 / d ** 0.5)).float().reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum("bkgsd,bktd->bkgst", qs, k.float())
    kj = torch.arange(sk, device=q.device)
    if causal:
        qi = torch.arange(s, device=q.device)
        logits = logits.masked_fill(qi[:, None] < kj[None, :], _NEG_INF)
    if kv_len is not None:
        invalid = kj[None, :] >= kv_len[:, None]                 # (B, Sk)
        logits = logits.masked_fill(invalid[:, None, None, None], _NEG_INF)
    return torch.softmax(logits, dim=-1)


def split_bf16x3(p: torch.Tensor):
    """The bf16 kernel's split of f32 ``p`` into bf16 pieces (hi, mid, lo):
    hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), so that
    hi + mid + lo = p exactly for |p| above about 1e-30 (below it lo loses
    bits to bf16's subnormals, an error under 1e-38)."""
    p = p.float()
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                pieces: int = 3) -> torch.Tensor:
    """:func:`flash_attention_plain` with P V taken as a sum of bf16
    products: the first ``pieces`` of :func:`split_bf16x3` (P), each times
    V in f32.  ``pieces=3`` is the bf16 kernel's arithmetic (P exact);
    ``pieces=1`` rounds P to bf16, which the f32 contract forbids."""
    w = _softmax_weights(q, k, causal)
    out = sum(torch.einsum("bkgst,bktd->bkgsd", piece.float(), v.float())
              for piece in split_bf16x3(w)[:pieces])
    return out.reshape(q.shape).to(q.dtype)


def lo_piece_probe(device="cuda", seed: int = 0):
    """bf16 inputs on which the output shows the third piece of P's split,
    and the exact value of that output, ``(q, k, v, want)``.

    One head, 64 queries, 64 keys, D = 16 (scale 1/4, exact), full
    attention.  Every query scores key 0 at a random ``a`` in (-0.9, -0.1),
    key 1 at ``a + 3 * 2^-19`` and keys 2-63 at 0, all exact in f32.  V is
    +1 for key 0 and -1 for key 1 in column 0, so output column 0 is
    ``(p0 - p1) / l``: the difference of two weights that agree in their
    first 16 bits, the bits hi and mid keep.  ``want`` (64,) is that column
    in f64.  Taken with all three pieces it lies about 1e-2 from ``want``;
    without lo, about 0.6."""
    s, d = 64, 16
    gen = torch.Generator().manual_seed(seed)
    a = (-0.1 - 0.8 * torch.rand(s, generator=gen, dtype=torch.float64)
         ).to(torch.bfloat16).double()
    delta = 3 * 2.0 ** -19
    q = torch.zeros(1, 1, s, d, dtype=torch.float64)
    q[0, 0, :, 0] = 4 * a
    q[0, 0, :, 1] = 4 * 3 * 2.0 ** -10
    k = torch.zeros_like(q)
    k[0, 0, :2, 0] = 1.0
    k[0, 0, 1, 1] = 2.0 ** -9                 # with q[..., 1]: 3 * 2^-19
    v = torch.zeros_like(q)
    v[0, 0, 0, 0], v[0, 0, 1, 0] = 1.0, -1.0
    p0, p1 = a.exp(), (a + delta).exp()
    want = (p0 - p1) / ((s - 2) + p0 + p1)
    return (*(t.to(device=device, dtype=torch.bfloat16) for t in (q, k, v)),
            want.to(device))


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention {name}: expected a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                            f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4 or t.numel() == 0:
            raise ValueError(f"flash_attention {name}: expected a non-empty "
                             f"(B, H, S, D) tensor, got {tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention {name}: the head dimension must "
                             f"have unit stride, got strides {t.stride()}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes differ, q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1] != 0:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {k.shape[1]} KV heads")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dimension {d} exceeds the "
                         f"kernel's {MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16:
        # the bf16 kernel copies 16-byte rows with cp.async
        if d % 8:
            raise ValueError(f"flash_attention: the bf16 kernel takes a head "
                             f"dimension that is a multiple of 8, got {d}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3]):
                raise ValueError(
                    f"flash_attention {name}: the bf16 kernel takes a 16-byte "
                    f"aligned pointer and (batch, head, row) strides that are "
                    f"multiples of 8 elements, got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention over (B, Hq, S, D) queries and (B, Hkv, Sk, D) keys and
    values, ``Hq`` a multiple of ``Hkv`` (GQA), softmax scale 1/sqrt(D).

    Any strides over (B, H, S) are read in place (for bf16: multiples of 8
    elements, a 16-byte-aligned pointer, D a multiple of 8).  The output
    has Q's shape and dtype; on the card it is laid out as (B, S, Hq, D) in
    memory (a transposed view), so the model's transpose back is free.
    bf16 launches ``flash_mma_kernel`` (tensor cores, P exact), f32
    launches ``flash_kernel`` (f32 FMA); neither falls back to the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, s, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    err = build.launch(
        build.library().repro_flash_attention, q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, s, sk, d,
        int(causal), int(q.dtype == torch.bfloat16), *strides)
    build.check(err, "flash_attention")
    counting.tick_attr(flash_attention)
    return out


flash_attention.launches = 0
