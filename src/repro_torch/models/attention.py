"""GQA attention with RoPE, M-RoPE and qk-norm: full-sequence, cached
decode and cross-attention.

Counterpart of ``repro.models.attention``.  Public functions keep the
reference's (B, S, H, dh) layout.  Full-sequence attention and
cross-attention against encoder K/V (in decode too) go through
:func:`repro_torch.kernels.ops.attention` (the flash kernel on the card);
one-token self-attention decode stays plain torch, as in the reference,
where the matvec path is already memory-optimal: it calls the kernel's
plain version,
:func:`~repro_torch.kernels.flash_attention.flash_attention_plain`, with
the cache's valid length (the reference's ``_sdpa``).

On a mesh the decode cache is a ``DTensor`` placed by the reference's
``cache_shardings``: each rank writes a token's K/V into its own block and
attends over it (:func:`_attend_cache`), never gathering the cache.  Where
the cache's heads are split, each rank attends with its query heads; where
its sequence is split instead (the kv_seq fallback), each rank attends
over its block of positions and the partial softmax statistics are
combined across those ranks (max, rescale, sum: flash-decode).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import _NEG_INF, flash_attention_plain
from repro_torch.models.common import (Config, P_, apply_mrope, apply_rope,
                                      constrain, local_call, local_range,
                                      reshape, rms_norm, split_last, unshard)

# the (B, S, H, dh) layout's head axis constrained to the model axis
HEADS = ("batch", None, "act_heads", None)


def attn_specs(cfg: Config, n_layers: int) -> Dict[str, P_]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    L = (n_layers,)
    specs = {
        "wq": P_(L + (d, h, dh), ("layers", "embed", "heads", "head_dim")),
        "wk": P_(L + (d, kv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wv": P_(L + (d, kv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "wo": P_(L + (h, dh, d), ("layers", "heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = P_(L + (dh,), ("layers", "head_dim"), init="ones")
        specs["k_norm"] = P_(L + (dh,), ("layers", "head_dim"), init="ones")
    return specs


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return split_last(x @ reshape(w, d, h * k).to(x.dtype), h, k)


def _out(o, wo):
    """einsum('bshk,hkd->bsd') as one matmul, on a copy of o in the
    contiguous layout: a one-token o's strides are otherwise whatever its
    producer left on its length-1 axis, on a ``DTensor`` its local
    tensor's and its own may differ, and the matmul's route (and its
    rounding) follows them."""
    h, k, d = wo.shape
    o = o.clone(memory_format=torch.contiguous_format)
    return (reshape(o, *o.shape[:2], h * k)
            @ reshape(wo, h * k, d).to(o.dtype))


def _qkv(x, p, cfg: Config, positions, rope: bool):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope and positions is not None:
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return constrain(q, HEADS), constrain(k, HEADS), v


def _attend(q, k, v, causal: bool):
    """Full-sequence attention through the ``attention`` site, in the
    (B, S, H, dh) layout (the kernel reads the transposed views in place).

    Under a mesh the site runs on each rank's (batch, head) shards, on one
    layout for q, k and v: q's, if every mesh axis that splits q's heads
    splits k's too (then each rank's query heads read its own key and value
    heads), else q's with its heads whole."""
    def attend(q, k, v):
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)

    if not hasattr(q, "placements"):
        return attend(q, k, v)
    q = unshard(q, 1, 3)
    layout = constrain(k, HEADS).placements
    if any(pq != pk and pq.is_shard(2) for pq, pk in zip(q.placements,
                                                          layout)):
        q = unshard(q, 2)
    k, v = (t.redistribute(q.device_mesh, q.placements) for t in (k, v))
    return local_call(attend, (q, k, v), list(q.placements))


def attn_apply(x, p, cfg: Config, positions=None, causal: bool = True,
               rope: bool = True):
    """Full-sequence attention (train / prefill)."""
    q, k, v = _qkv(x, p, cfg, positions, rope)
    return _out(_attend(q, k, v, causal), p["wo"])


def attn_prefill(x, p, cfg: Config, positions=None, rope: bool = True):
    """Prefill: returns output and the (k, v) cache for this layer."""
    q, k, v = _qkv(x, p, cfg, positions, rope)
    return _out(_attend(q, k, v, True), p["wo"]), (k, v)


def write_kv(cache, kv, start: int) -> None:
    """``cache[:, start:start + s] = kv`` in place: cache (B, S, KV, dh),
    kv (B, s, KV, dh), cast to the cache's dtype.  On a ``DTensor`` cache
    each rank writes the positions of its own block that the window covers
    (kv whole along its sequence, placed as the cache elsewhere)."""
    s = kv.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, start:start + s] = kv
        return
    mesh = cache.device_mesh
    want = tuple(Replicate() if pl.is_shard(1) else pl
                 for pl in cache.placements)
    if tuple(kv.placements) != want:
        kv = kv.redistribute(mesh, want)
    lo, hi = local_range(cache, 1)
    a, b = max(lo, start), min(hi, start + s)
    if a < b:
        cache.to_local()[:, a - lo:b - lo] = kv.to_local()[:, a - start:
                                                           b - start]


def _combined(q, k, v, n: int, groups):
    """Non-causal attention of q (B, H, s, dh) over the first ``n``
    positions of this rank's block k, v (B, KV, S_blk, dh), combined with
    the other blocks across ``groups`` (the process groups of the mesh
    axes that split the sequence): each rank's max, its sum of exp and its
    unnormalised output in f32, rescaled to the max over the ranks and
    summed.  Q is scaled in its own dtype as
    :func:`flash_attention_plain` does."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qs = (q * (1.0 / d ** 0.5)).float().reshape(b, hkv, hq // hkv, s, d)
    logits = torch.einsum("bkgsd,bktd->bkgst", qs, k.float())
    logits[..., n:] = _NEG_INF
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    top = m.clone()
    for g in groups:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
    scale = torch.exp(m - top)
    total = p.sum(dim=-1, keepdim=True) * scale
    acc = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) * scale
    for g in groups:
        dist.all_reduce(total, group=g)
        dist.all_reduce(acc, group=g)
    return (acc / total).reshape(q.shape).to(q.dtype)


def _attend_cache(q, cache_k, cache_v, kv_len: int):
    """q (B, s, H, dh) against the first ``kv_len`` positions of a
    ``DTensor`` cache (B, S, KV, dh), non-causally, on each rank's block of
    the cache: its batch rows and heads with the query heads that read
    them, and, where the cache's sequence is split, its positions, the
    partial results combined by :func:`_combined`.  Returns (B, s, H, dh)
    placed as the queries."""
    mesh = cache_k.device_mesh
    seq = [i for i, pl in enumerate(cache_k.placements) if pl.is_shard(1)]
    want = tuple(pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
                 for pl in cache_k.placements)
    if tuple(q.placements) != want:
        q = q.redistribute(mesh, want)
    ql = q.to_local().transpose(1, 2)
    kl = cache_k.to_local().to(ql.dtype).transpose(1, 2)
    vl = cache_v.to_local().to(ql.dtype).transpose(1, 2)
    if seq:
        lo, hi = local_range(cache_k, 1)
        out = _combined(ql, kl, vl, min(max(kv_len - lo, 0), hi - lo),
                        [mesh.get_group(i) for i in seq])
    else:
        out = flash_attention_plain(
            ql, kl, vl, causal=False,
            kv_len=torch.full((ql.shape[0],), kv_len, device=ql.device))
    return DTensor.from_local(out.transpose(1, 2), mesh, want,
                              shape=q.shape, stride=q.stride())


def attn_decode(x, p, cfg: Config, cache_k, cache_v, index: int,
                positions=None, rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D); cache_{k,v}: (B,S,KV,dh); index: int.

    Writes this token's k and v into the caches at ``index`` in place (the
    reference returns updated copies) and returns (out, cache_k, cache_v).
    A full cache raises: the reference's ``dynamic_update_slice`` would
    clamp the write onto the last slot instead.  ``DTensor`` caches: see
    the module docstring."""
    max_seq = cache_k.shape[1]
    if not 0 <= index < max_seq:
        raise ValueError(f"attn_decode: the KV cache holds {max_seq} tokens "
                         f"and position {index} is past its end; prefill "
                         f"with a larger max_seq")
    q, k, v = _qkv(x, p, cfg, positions, rope)
    write_kv(cache_k, k, index)
    write_kv(cache_v, v, index)
    if isinstance(cache_k, DTensor):
        return (_out(_attend_cache(q, cache_k, cache_v, index + 1), p["wo"]),
                cache_k, cache_v)
    kv_len = torch.full((x.shape[0],), index + 1, device=x.device)
    out = flash_attention_plain(
        q.transpose(1, 2), cache_k.to(q.dtype).transpose(1, 2),
        cache_v.to(q.dtype).transpose(1, 2), causal=False, kv_len=kv_len)
    return _out(out.transpose(1, 2), p["wo"]), cache_k, cache_v


def cross_attn_apply(x, p, cfg: Config, mem_k, mem_v):
    """Cross-attention of x (B, S, D) against precomputed encoder K/V
    (B, T, KV, dh), through the ``attention`` site (non-causal).  A
    ``DTensor`` cross cache split along its frames (the kv_seq fallback)
    is attended block by block and combined, as :func:`attn_decode`
    does."""
    q = _proj(x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    q = constrain(q, HEADS)
    if isinstance(mem_k, DTensor) and any(pl.is_shard(1)
                                          for pl in mem_k.placements):
        return _out(_attend_cache(q, mem_k, mem_v, mem_k.shape[1]), p["wo"])
    out = _attend(q, mem_k.to(q.dtype), mem_v.to(q.dtype), causal=False)
    return _out(out, p["wo"])


def cross_kv(mem, p, cfg: Config):
    """Encoder memory (B, T, D) -> cross K/V with this layer's wk/wv."""
    k, v = _proj(mem, p["wk"]), _proj(mem, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v
