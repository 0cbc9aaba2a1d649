"""Decoder stacks: the hybrid (Zamba2) family, full-sequence, prefill and
decode.

Counterpart of ``repro.models.transformer``.  Layer parameters stay stacked
on their leading axis; where the reference scans, the port loops in
Python.  The hybrid stack runs groups of Mamba2 blocks, each group closed
by one attention + SwiGLU block whose weights every group shares.  The
dense, moe, ssm and encdec families are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import FAMILY_ITEMS
from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Config, P_, rms_norm, swiglu, take


def _only_hybrid(cfg: Config, what: str) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"{what} for the {cfg.family} family is not ported to repro_torch "
            f"yet: ROADMAP.md §1, {FAMILY_ITEMS[cfg.family]}")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def mlp_specs(cfg: Config, n_layers: int) -> Dict[str, P_]:
    d, f = cfg.d_model, cfg.d_ff
    L = (n_layers,)
    return {"wg": P_(L + (d, f)), "wu": P_(L + (d, f)), "wd": P_(L + (f, d))}


def block_specs(cfg: Config, n_layers: int) -> Dict[str, object]:
    """An attention + SwiGLU block (the hybrid family's shared block)."""
    L = (n_layers,)
    return {
        "ln1": P_(L + (cfg.d_model,), init="ones"),
        "ln2": P_(L + (cfg.d_model,), init="ones"),
        "attn": att.attn_specs(cfg, n_layers),
        "mlp": mlp_specs(cfg, n_layers),
    }


def lm_specs(cfg: Config) -> Dict[str, object]:
    _only_hybrid(cfg, "lm_specs")
    n_groups = cfg.n_layers // cfg.hybrid_group
    per = cfg.hybrid_group - 1           # mamba blocks per group
    return {
        "embed": P_((cfg.vocab, cfg.d_model)),
        "final_norm": P_((cfg.d_model,), init="ones"),
        "head": P_((cfg.d_model, cfg.vocab)),
        "ssm_ln": P_((n_groups, per, cfg.d_model), init="ones"),
        "ssm": {k: P_((n_groups,) + s.shape, init=s.init)
                for k, s in ssm_mod.ssm_specs(cfg, per).items()},
        "shared": block_specs(_dense(cfg), 1),   # one shared attn+mlp block
    }


def _dense(cfg: Config) -> Config:
    return dataclasses.replace(cfg, family="dense")


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _dense_block(x, lp, cfg: Config, positions):
    h = x + att.attn_apply(rms_norm(x, lp["ln1"]), lp["attn"], cfg, positions)
    z = rms_norm(h, lp["ln2"])
    return h + swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])


def _groups(cfg: Config) -> Tuple[int, int]:
    return cfg.n_layers // cfg.hybrid_group, cfg.hybrid_group - 1


def _hybrid_forward(x, params, cfg: Config, positions):
    """Groups of Mamba2 blocks, each closed by the shared attention block."""
    shared = take(params["shared"], 0)
    dense_cfg = _dense(cfg)
    n_groups, per = _groups(cfg)
    for g in range(n_groups):
        for i in range(per):
            x = x + ssm_mod.ssm_apply(rms_norm(x, params["ssm_ln"][g, i]),
                                      take(params["ssm"], (g, i)), cfg)
        x = _dense_block(x, shared, dense_cfg, positions)
    return x


def default_positions(cfg: Config, b: int, s: int, device=None):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed(params, cfg: Config, tokens):
    return params["embed"][tokens].to(cfg.act_dtype)


def _logits(x, params):
    return rms_norm(x, params["final_norm"]) @ params["head"].to(x.dtype)


def forward(params, cfg: Config, tokens, positions=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    _only_hybrid(cfg, "forward")
    x = _embed(params, cfg, tokens)
    b, s = x.shape[:2]
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    return _logits(_hybrid_forward(x, params, cfg, positions), params)


# ---------------------------------------------------------------------------
# Decode (serve_step) and prefill
# ---------------------------------------------------------------------------

class CacheSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_cache_specs(cfg: Config, batch: int, max_seq: int,
                     dtype=torch.bfloat16) -> Dict[str, CacheSpec]:
    """Shapes and dtypes of the decode cache; ``index`` is a Python int in
    the port's cache (a scalar int32 in the reference's)."""
    _only_hybrid(cfg, "init_cache_specs")
    n_groups, per = _groups(cfg)
    kv, dh = cfg.n_kv_heads, cfg.d_head
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "ssm_h": CacheSpec((n_groups, per, batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), torch.float32),
        "ssm_conv": CacheSpec((n_groups, per, batch, cfg.conv_width - 1,
                               conv_dim), dtype),
        "k": CacheSpec((n_groups, batch, max_seq, kv, dh), dtype),
        "v": CacheSpec((n_groups, batch, max_seq, kv, dh), dtype),
        "index": CacheSpec((), torch.int32),
    }


def init_cache(cfg: Config, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """A zero decode cache at position 0."""
    device = resolve_device(device)
    cache = {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for name, s in init_cache_specs(cfg, batch, max_seq, dtype).items()
             if name != "index"}
    cache["index"] = 0
    return cache


def _attn_block_decode(x, lp, cfg: Config, ck, cv, index, positions):
    a_out, nk, nv = att.attn_decode(rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                                    ck, cv, index, positions)
    h = x + a_out
    z = rms_norm(h, lp["ln2"])
    return h + swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"]), \
        nk, nv


def decode_step(params, cfg: Config, cache, token, positions=None):
    """One decode step: token (B, 1) -> (logits (B, V), new cache).

    ``k``, ``v`` and ``ssm_h`` are updated in place (the reference returns
    new arrays; copying them per token would move the whole cache); the
    returned dict holds the same tensors, the new ``ssm_conv`` and
    ``index + 1``."""
    _only_hybrid(cfg, "decode_step")
    x = _embed(params, cfg, token)                      # (B, 1, D)
    index = int(cache["index"])
    if positions is None:
        positions = torch.full((token.shape[0], 1), index, dtype=torch.int32,
                               device=x.device)
    shared = take(params["shared"], 0)
    dense_cfg = _dense(cfg)
    n_groups, per = _groups(cfg)
    convs = []
    for g in range(n_groups):
        for i in range(per):
            out, (h_new, conv_new) = ssm_mod.ssm_decode(
                rms_norm(x, params["ssm_ln"][g, i]), take(params["ssm"], (g, i)),
                cfg, (cache["ssm_h"][g, i], cache["ssm_conv"][g, i]))
            x = x + out
            cache["ssm_h"][g, i] = h_new
            convs.append(conv_new)
        x, _, _ = _attn_block_decode(x, shared, dense_cfg, cache["k"][g],
                                     cache["v"][g], index, positions)
    conv = torch.stack(convs).reshape(n_groups, per, *convs[0].shape)
    logits = _logits(x, params)[:, 0]
    return logits, dict(cache, ssm_conv=conv, index=index + 1)


def prefill(params, cfg: Config, tokens, max_seq: int, positions=None,
            cache_dtype=torch.bfloat16):
    """Prefill the decode cache from a full prompt: the full-sequence
    forward that also emits each Mamba2 layer's final SSD state and conv
    tail and each shared-attention layer's K/V (padded to ``max_seq``).
    Returns (last-position logits (B, V), cache)."""
    _only_hybrid(cfg, "prefill")
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prefill: a {s}-token prompt does not fit a "
                         f"{max_seq}-token cache")
    x = _embed(params, cfg, tokens)
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    cache = init_cache(cfg, b, max_seq, cache_dtype, x.device)
    shared = take(params["shared"], 0)
    dense_cfg = _dense(cfg)
    n_groups, per = _groups(cfg)
    for g in range(n_groups):
        for i in range(per):
            out, (h_f, conv) = ssm_mod.ssm_apply(
                rms_norm(x, params["ssm_ln"][g, i]),
                take(params["ssm"], (g, i)), cfg, return_state=True)
            x = x + out
            cache["ssm_h"][g, i] = h_f
            cache["ssm_conv"][g, i] = conv.to(cache_dtype)
        a_out, (k, v) = att.attn_prefill(rms_norm(x, shared["ln1"]),
                                         shared["attn"], dense_cfg, positions)
        h2 = x + a_out
        z = rms_norm(h2, shared["ln2"])
        x = h2 + swiglu(z, shared["mlp"]["wg"], shared["mlp"]["wu"],
                        shared["mlp"]["wd"])
        cache["k"][g, :, :s] = k.to(cache_dtype)
        cache["v"][g, :, :s] = v.to(cache_dtype)
    cache["index"] = s
    return _logits(x[:, -1], params), cache
