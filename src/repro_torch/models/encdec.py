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
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models.common import (Config, P_, cross_entropy, remat,
                                      rms_norm, swiglu, take, unstack)
from repro_torch.models.transformer import CacheSpec, mlp_specs

# learned decoder positions: the reference sizes them for its largest
# decode shape
DEC_POSITIONS = 32768


def encdec_specs(cfg: Config) -> Dict[str, object]:
    le, ld, d = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    return {
        "embed": P_((cfg.vocab, d)),
        "pos_dec": P_((DEC_POSITIONS, d), init="small"),
        "enc": {
            "ln1": P_((le, d), init="ones"),
            "ln2": P_((le, d), init="ones"),
            "attn": att.attn_specs(cfg, le),
            "mlp": mlp_specs(cfg, le),
        },
        "enc_norm": P_((d,), init="ones"),
        "dec": {
            "ln1": P_((ld, d), init="ones"),
            "ln_x": P_((ld, d), init="ones"),
            "ln2": P_((ld, d), init="ones"),
            "attn": att.attn_specs(cfg, ld),
            "xattn": att.attn_specs(cfg, ld),
            "mlp": mlp_specs(cfg, ld),
        },
        "final_norm": P_((d,), init="ones"),
        "head": P_((d, cfg.vocab)),
    }


def _mlp(h, lp):
    z = rms_norm(h, lp["ln2"])
    return h + swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])


def _logits(x, params):
    return rms_norm(x, params["final_norm"]) @ params["head"].to(x.dtype)


def encode(params, cfg: Config, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) stub embeddings -> encoder output (B, T, D)."""
    def layer(x, lp):
        h = x + att.attn_apply(rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                               positions=None, causal=False, rope=False)
        return _mlp(h, lp)

    x = frames.to(cfg.act_dtype)
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
    x = params["embed"][tokens].to(cfg.act_dtype)
    x = x + params["pos_dec"][:s].to(x.dtype)[None]
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


def init_cache(cfg: Config, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """A zero decode cache at position 0 (``xk``/``xv`` to be filled)."""
    device = resolve_device(device)
    cache = {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for name, s in init_cache_specs(cfg, batch, max_seq, dtype).items()
             if name != "index"}
    cache["index"] = 0
    return cache


def decode_step(params, cfg: Config, cache, token, positions=None):
    """One decoder token (B, 1) -> (logits (B, V), cache): self-attention
    over ``k``/``v`` (this token's K and V written in place at ``index``)
    and cross-attention over ``xk``/``xv``.  ``positions`` is accepted for
    the bundle's signature and unused: the decoder's positions are learned
    and taken at ``index``, as in the reference."""
    index = int(cache["index"])
    x = params["embed"][token].to(cfg.act_dtype)
    x = x + params["pos_dec"][index].to(x.dtype)
    for i in range(cfg.n_layers):
        lp = take(params["dec"], i)
        a_out, _, _ = att.attn_decode(rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                                      cache["k"][i], cache["v"][i], index,
                                      positions=None, rope=False)
        h = x + a_out
        h = h + att.cross_attn_apply(rms_norm(h, lp["ln_x"]), lp["xattn"],
                                     cfg, cache["xk"][i].to(x.dtype),
                                     cache["xv"][i].to(x.dtype))
        x = _mlp(h, lp)
    return _logits(x, params)[:, 0], dict(cache, index=index + 1)
