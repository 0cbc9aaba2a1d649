"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

Counterpart of ``repro.models.encdec``, for serving and training.  The encoder takes
precomputed frame embeddings (B, T, D) (the conv frontend is out of scope,
as in the reference) and runs non-causal attention + SwiGLU blocks with no
rotary embedding.  The decoder adds learned positions, causal
self-attention, and cross-attention against the encoder output through
per-layer cross K/V.  Self-attention, cross-attention and the encoder all
go through the ``attention`` site (the flash kernel on the card), except
one-token self-attention decode, which stays plain as in
:func:`~repro_torch.models.attention.attn_decode`.

The decode cache holds the self-attention ``k``/``v``, written in place,
and the cross ``xk``/``xv``, which the caller fills with
:func:`~repro_torch.models.attention.cross_kv` of the encoder output, as
with the reference.  Under ``cfg.remat`` each encoder and decoder layer
of ``encode`` and ``decode_train`` is checkpointed, where the reference
wraps its scan bodies in ``jax.checkpoint`` (the reference's own remat path
raises ``NameError``: it names an undefined ``_ckpt_policy``).

On a mesh the cache is placed by the reference's rules
(:func:`cache_logical_axes`, ``common.cache_shardings``); a caller fills
``xk``/``xv`` of layer ``i`` with ``common.assign(common.slot(cache["xk"],
i), k)``, and :func:`decode_step` attends on each rank's block.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import attention as att
from repro_torch.models.common import (ACT_EMBED, Config, P_, constrain,
                                      cross_entropy, lookup, remat,
                                      replicating, rms_norm, slot, swiglu,
                                      unstack, zero_cache)
from repro_torch.models.transformer import CacheSpec, mlp_specs

# learned decoder positions: the reference sizes them for its largest
# decode shape
DEC_POSITIONS = 32768


def encdec_specs(cfg: Config) -> Dict[str, object]:
    le, ld, d = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    return {
        "embed": P_((cfg.vocab, d), ("vocab", "embed")),
        "pos_dec": P_((DEC_POSITIONS, d), (None, "embed"), init="small"),
        "enc": {
            "ln1": P_((le, d), ("layers", "embed"), init="ones"),
            "ln2": P_((le, d), ("layers", "embed"), init="ones"),
            "attn": att.attn_specs(cfg, le),
            "mlp": mlp_specs(cfg, le),
        },
        "enc_norm": P_((d,), ("embed",), init="ones"),
        "dec": {
            "ln1": P_((ld, d), ("layers", "embed"), init="ones"),
            "ln_x": P_((ld, d), ("layers", "embed"), init="ones"),
            "ln2": P_((ld, d), ("layers", "embed"), init="ones"),
            "attn": att.attn_specs(cfg, ld),
            "xattn": att.attn_specs(cfg, ld),
            "mlp": mlp_specs(cfg, ld),
        },
        "final_norm": P_((d,), ("embed",), init="ones"),
        "head": P_((d, cfg.vocab), ("embed", "vocab")),
    }


def _mlp(h, lp):
    """The layer's SwiGLU with its residual: the layer's output."""
    z = rms_norm(h, lp["ln2"])
    out = h + swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])
    return constrain(out, ACT_EMBED)


def _logits(x, params):
    return rms_norm(x, params["final_norm"]) @ params["head"].to(x.dtype)


def encode(params, cfg: Config, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) stub embeddings -> encoder output (B, T, D)."""
    def layer(x, lp):
        h = x + att.attn_apply(rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                               positions=None, causal=False, rope=False)
        return _mlp(h, lp)

    norm = params["enc_norm"]
    if isinstance(norm, DTensor) and not isinstance(frames, DTensor):
        # the same frames on every rank, split by the constraint below
        frames = DTensor.from_local(frames, norm.device_mesh,
                                    [Replicate()] * norm.device_mesh.ndim)
    with replicating(norm):
        x = constrain(frames.to(cfg.act_dtype), ACT_EMBED)
        for lp in unstack(params["enc"]):
            x = remat(layer, cfg)(x, lp)
        return rms_norm(x, params["enc_norm"])


def decode_train(params, cfg: Config, tokens, enc_out) -> torch.Tensor:
    """Teacher-forced decoder over tokens (B, S) -> logits (B, S, V)."""
    def layer(x, lp, enc_out):
        h = x + att.attn_apply(rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                               positions=None, causal=True, rope=False)
        mk, mv = att.cross_kv(enc_out, lp["xattn"], cfg)
        h = h + att.cross_attn_apply(rms_norm(h, lp["ln_x"]), lp["xattn"],
                                     cfg, mk, mv)
        return _mlp(h, lp)

    s = tokens.shape[1]
    x = lookup(params["embed"], tokens).to(cfg.act_dtype)
    x = constrain(x + params["pos_dec"][:s].to(x.dtype)[None], ACT_EMBED)
    for lp in unstack(params["dec"]):
        x = remat(layer, cfg)(x, lp, enc_out)
    return _logits(x, params)


def loss_fn(params, cfg: Config, batch) -> torch.Tensor:
    """Mean cross-entropy of the decoder over ``batch``'s ``tokens`` and
    ``labels``, attending to the encoded ``frames``."""
    enc_out = encode(params, cfg, batch["frames"])
    return cross_entropy(decode_train(params, cfg, batch["tokens"], enc_out),
                         batch["labels"])


def init_cache_specs(cfg: Config, batch: int, max_seq: int,
                     dtype=torch.bfloat16) -> Dict[str, CacheSpec]:
    """Self-attention ``k``/``v`` over ``max_seq`` positions and cross
    ``xk``/``xv`` over ``enc_frames``, per decoder layer; ``index`` is a
    Python int in the port's cache."""
    kv, dh, ld = cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    self_kv = CacheSpec((ld, batch, max_seq, kv, dh), dtype)
    cross_kv = CacheSpec((ld, batch, cfg.enc_frames, kv, dh), dtype)
    return {"k": self_kv, "v": self_kv, "xk": cross_kv, "xv": cross_kv,
            "index": CacheSpec((), torch.int32)}


def cache_logical_axes(cfg: Config) -> Dict[str, tuple]:
    """The reference's logical axes of each cache entry: self and cross
    K/V alike, (layers, batch, kv_seq, kv_heads, head_dim)."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "index": ()}


def init_cache(cfg: Config, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None, mesh=None):
    """A zero decode cache at position 0 (``xk``/``xv`` to be filled); on
    ``mesh``, ``DTensor``s placed by ``common.cache_shardings``."""
    return zero_cache(init_cache_specs(cfg, batch, max_seq, dtype),
                      cache_logical_axes(cfg), device, mesh)


def decode_step(params, cfg: Config, cache, token, positions=None):
    """One decoder token (B, 1) -> (logits (B, V), cache): self-attention
    over ``k``/``v`` (this token's K and V written in place at ``index``)
    and cross-attention over ``xk``/``xv``.  ``positions`` is accepted for
    the bundle's signature and unused: the decoder's positions are learned
    and taken at ``index``, as in the reference."""
    index = int(cache["index"])
    with replicating(params["embed"]):
        x = lookup(params["embed"], token).to(cfg.act_dtype)
        x = constrain(x + params["pos_dec"][index].to(x.dtype), ACT_EMBED)
        for i, lp in enumerate(unstack(params["dec"])):
            a_out, _, _ = att.attn_decode(
                rms_norm(x, lp["ln1"]), lp["attn"], cfg, slot(cache["k"], i),
                slot(cache["v"], i), index, positions=None, rope=False)
            h = x + a_out
            h = h + att.cross_attn_apply(
                rms_norm(h, lp["ln_x"]), lp["xattn"], cfg,
                slot(cache["xk"], i).to(x.dtype),
                slot(cache["xv"], i).to(x.dtype))
            x = _mlp(h, lp)
        return _logits(x, params)[:, 0], dict(cache, index=index + 1)
