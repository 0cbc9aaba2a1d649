"""Flash attention (online softmax) for the LM substrate.

Counterpart of ``repro.kernels.flash_attention``.  On a CUDA tensor
:func:`flash_attention` launches ``csrc/flash_attention.cu`` (one block per
64-row query tile of one (batch, head), the key axis a loop inside the
block, GQA read in place); on a CPU tensor it uses
:func:`flash_attention_plain`, the same function in plain torch.
"""
from __future__ import annotations

from typing import Optional

import torch

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
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention over (B, Hq, S, D) queries and (B, Hkv, Sk, D) keys and
    values, ``Hq`` a multiple of ``Hkv`` (GQA), softmax scale 1/sqrt(D).

    Any strides over (B, H, S) are read in place.  The output has Q's shape
    and dtype; on the card it is laid out as (B, S, Hq, D) in memory (a
    transposed view), so the model's transpose back is free."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, s, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    err = build.library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        s, sk, d, int(causal), int(q.dtype == torch.bfloat16), *strides,
        build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
