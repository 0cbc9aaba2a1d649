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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.common import (Config, P_, apply_mrope, apply_rope,
                                      constrain, local_call, reshape,
                                      rms_norm, split_last, unshard)

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
    """einsum('bshk,hkd->bsd') as one matmul."""
    h, k, d = wo.shape
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


def attn_decode(x, p, cfg: Config, cache_k, cache_v, index: int,
                positions=None, rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D); cache_{k,v}: (B,S,KV,dh); index: int.

    Writes this token's k and v into the caches at ``index`` in place (the
    reference returns updated copies) and returns (out, cache_k, cache_v).
    A full cache raises: the reference's ``dynamic_update_slice`` would
    clamp the write onto the last slot instead."""
    max_seq = cache_k.shape[1]
    if not 0 <= index < max_seq:
        raise ValueError(f"attn_decode: the KV cache holds {max_seq} tokens "
                         f"and position {index} is past its end; prefill "
                         f"with a larger max_seq")
    q, k, v = _qkv(x, p, cfg, positions, rope)
    cache_k[:, index] = k[:, 0].to(cache_k.dtype)
    cache_v[:, index] = v[:, 0].to(cache_v.dtype)
    kv_len = torch.full((x.shape[0],), index + 1, device=x.device)
    out = flash_attention_plain(
        q.transpose(1, 2), cache_k.to(q.dtype).transpose(1, 2),
        cache_v.to(q.dtype).transpose(1, 2), causal=False, kv_len=kv_len)
    return _out(out.transpose(1, 2), p["wo"]), cache_k, cache_v


def cross_attn_apply(x, p, cfg: Config, mem_k, mem_v):
    """Cross-attention of x (B, S, D) against precomputed encoder K/V
    (B, T, KV, dh), through the ``attention`` site (non-causal)."""
    q = _proj(x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    q = constrain(q, HEADS)
    out = _attend(q, mem_k.to(q.dtype), mem_v.to(q.dtype), causal=False)
    return _out(out, p["wo"])


def cross_kv(mem, p, cfg: Config):
    """Encoder memory (B, T, D) -> cross K/V with this layer's wk/wv."""
    k, v = _proj(mem, p["wk"]), _proj(mem, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v
