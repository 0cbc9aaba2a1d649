"""Decoder stacks of the dense, moe, vlm, ssm (Mamba2) and hybrid
(Zamba2) families: full-sequence (and its training loss), prefill and
decode.

Counterpart of ``repro.models.transformer``.  Layer parameters stay stacked
on their leading axis; where the reference scans, the port loops in
Python.  The dense and vlm stacks run one attention + SwiGLU block per
layer, the moe stack one attention + MoE block (plus a dense SwiGLU
residual under ``moe_dense_residual``), the ssm stack one Mamba2 block per
layer, and the hybrid stack groups of Mamba2 blocks, each group closed by
one attention + SwiGLU block whose weights every group shares.  The vlm
family rotates by M-RoPE over (3, B, S) positions.  The encdec family has
its own stack, :mod:`repro_torch.models.encdec`.  Under ``cfg.remat`` the
full-sequence forward checkpoints each block where the reference wraps its
scan body in ``jax.checkpoint``: every dense, moe and vlm block and every
Mamba2 block, but not the hybrid family's shared attention block.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (Config, P_, cross_entropy, remat,
                                      rms_norm, swiglu, take, unstack)


def _check_family(cfg: Config, what: str) -> None:
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        raise ValueError(
            f"{what}: the {cfg.family} family has no decoder-only stack; the "
            f"encdec family is served by repro_torch.models.encdec")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def mlp_specs(cfg: Config, n_layers: int) -> Dict[str, P_]:
    d, f = cfg.d_model, cfg.d_ff
    L = (n_layers,)
    return {"wg": P_(L + (d, f)), "wu": P_(L + (d, f)), "wd": P_(L + (f, d))}


def block_specs(cfg: Config, n_layers: int) -> Dict[str, object]:
    """Attention + FFN blocks: the dense, moe and vlm families' layers, the
    hybrid family's shared block.  The FFN is SwiGLU, or for moe the
    experts (plus SwiGLU under ``moe_dense_residual``)."""
    L = (n_layers,)
    specs: Dict[str, object] = {
        "ln1": P_(L + (cfg.d_model,), init="ones"),
        "ln2": P_(L + (cfg.d_model,), init="ones"),
        "attn": att.attn_specs(cfg, n_layers),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_mod.moe_specs(cfg, n_layers)
    if cfg.family != "moe" or cfg.moe_dense_residual:
        specs["mlp"] = mlp_specs(cfg, n_layers)
    return specs


def lm_specs(cfg: Config) -> Dict[str, object]:
    _check_family(cfg, "lm_specs")
    specs: Dict[str, object] = {
        "embed": P_((cfg.vocab, cfg.d_model)),
        "final_norm": P_((cfg.d_model,), init="ones"),
        "head": P_((cfg.d_model, cfg.vocab)),
    }
    if cfg.family == "ssm":
        specs["ssm_ln"] = P_((cfg.n_layers, cfg.d_model), init="ones")
        specs["ssm"] = ssm_mod.ssm_specs(cfg, cfg.n_layers)
    elif cfg.family == "hybrid":
        n_groups, per = _groups(cfg)
        specs["ssm_ln"] = P_((n_groups, per, cfg.d_model), init="ones")
        specs["ssm"] = {k: P_((n_groups,) + s.shape, init=s.init)
                        for k, s in ssm_mod.ssm_specs(cfg, per).items()}
        specs["shared"] = block_specs(_dense(cfg), 1)   # one shared block
    else:
        specs["layers"] = block_specs(cfg, cfg.n_layers)
    return specs


def _dense(cfg: Config) -> Config:
    return dataclasses.replace(cfg, family="dense")


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _groups(cfg: Config) -> Tuple[int, int]:
    return cfg.n_layers // cfg.hybrid_group, cfg.hybrid_group - 1


def _layers(params, cfg: Config) -> Iterator[tuple]:
    """The stack in order, as (kind, idx, layer params, layer config).

    ``kind`` "ssm": a Mamba2 block whose ``ssm_ln``/``ssm`` parameters and
    cache slots sit at ``idx`` (a layer, or a (group, layer) pair).
    ``kind`` "attn": an attention + FFN block whose ``k``/``v`` cache
    slot is ``idx``.  Dense, moe, vlm: one attention block per layer; ssm:
    one Mamba2 block per layer; hybrid: groups of Mamba2 blocks, each closed
    by the attention block whose weights every group shares."""
    if cfg.family in ("dense", "moe", "vlm"):
        for i, lp in enumerate(unstack(params["layers"])):
            yield "attn", i, lp, cfg
    elif cfg.family == "ssm":
        for i, lp in enumerate(_ssm_layers(params["ssm_ln"], params["ssm"])):
            yield "ssm", i, lp, cfg
    else:
        shared, dense_cfg = take(params["shared"], 0), _dense(cfg)
        groups = _ssm_layers(params["ssm_ln"], params["ssm"])
        for g, group in enumerate(groups):
            for i, lp in enumerate(_ssm_layers(group["ln"], group["ssm"])):
                yield "ssm", (g, i), lp, cfg
            yield "attn", g, shared, dense_cfg


def _ssm_layers(ln, ssm):
    """Mamba2 norms and parameters unstacked along their leading axis (the
    layers, or the hybrid family's groups and then a group's layers), as
    ``{"ln", "ssm"}`` pairs."""
    return [{"ln": n, "ssm": sp} for n, sp in zip(unstack(ln), unstack(ssm))]


def _ffn(z, lp, cfg: Config):
    """The block's FFN on the normed z: the experts, the experts plus the
    dense SwiGLU residual, or SwiGLU."""
    if cfg.family != "moe":
        return swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])
    m = moe_mod.moe_apply(z, lp["moe"], cfg)
    if cfg.moe_dense_residual:
        m = m + swiglu(z, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])
    return m


def _attn_block(x, lp, cfg: Config, positions, cache=None, idx=None):
    """An attention + FFN block over the sequence; with a ``cache``, its K
    and V go into the first positions of ``k``/``v`` at ``idx``."""
    a_out, (k, v) = att.attn_prefill(rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                                     positions)
    if cache is not None:
        cache["k"][idx, :, :k.shape[1]] = k
        cache["v"][idx, :, :v.shape[1]] = v
    h = x + a_out
    return h + _ffn(rms_norm(h, lp["ln2"]), lp, cfg)


def _mamba_block(x, lp, cfg: Config, cache=None, idx=None):
    """A Mamba2 block over the sequence, with its residual; with a
    ``cache``, its final SSD state and conv tail go into it at ``idx``."""
    res = ssm_mod.ssm_apply(rms_norm(x, lp["ln"]), lp["ssm"], cfg,
                            return_state=cache is not None)
    if cache is None:
        return x + res
    out, (h_f, conv) = res
    cache["ssm_h"][idx] = h_f
    cache["ssm_conv"][idx] = conv
    return x + out


def _run_stack(x, params, cfg: Config, positions, cache=None):
    """The stack over x; without a ``cache``, each block is checkpointed as
    ``cfg.remat`` asks (see the module docstring)."""
    for kind, idx, lp, lcfg in _layers(params, cfg):
        if cache is not None:
            x = (_attn_block(x, lp, lcfg, positions, cache, idx)
                 if kind == "attn" else _mamba_block(x, lp, lcfg, cache, idx))
        elif kind == "ssm":
            x = remat(lambda h, lp=lp: _mamba_block(h, lp, cfg), cfg)(x)
        elif cfg.family == "hybrid":
            x = _attn_block(x, lp, lcfg, positions)
        else:
            x = remat(lambda h, lp=lp: _attn_block(h, lp, cfg, positions),
                      cfg)(x)
    return x


def default_positions(cfg: Config, b: int, s: int, device=None):
    """Positions 0..s-1 for each row: (B, S), or (3, B, S) under M-RoPE
    (text only: the three streams equal)."""
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    return pos.expand(3, b, s) if cfg.mrope_sections is not None else pos


def _embed(params, cfg: Config, tokens):
    return params["embed"][tokens].to(cfg.act_dtype)


def _logits(x, params):
    return rms_norm(x, params["final_norm"]) @ params["head"].to(x.dtype)


def forward(params, cfg: Config, tokens, positions=None,
            embeddings=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V).  ``embeddings`` (B, S, D),
    where given, replace the token embeddings (the vlm's entry for stubbed
    vision features)."""
    _check_family(cfg, "forward")
    x = (_embed(params, cfg, tokens) if embeddings is None
         else embeddings.to(cfg.act_dtype))
    b, s = x.shape[:2]
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    return _logits(_run_stack(x, params, cfg, positions), params)


def loss_fn(params, cfg: Config, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch``: ``tokens`` and
    ``labels`` (B, S), with ``positions`` and ``embeddings`` where it holds
    them."""
    logits = forward(params, cfg, batch["tokens"],
                     positions=batch.get("positions"),
                     embeddings=batch.get("embeddings"))
    return cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Decode (serve_step) and prefill
# ---------------------------------------------------------------------------

class CacheSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def init_cache_specs(cfg: Config, batch: int, max_seq: int,
                     dtype=torch.bfloat16) -> Dict[str, CacheSpec]:
    """Shapes and dtypes of the decode cache; ``index`` is a Python int in
    the port's cache (a scalar int32 in the reference's).  Dense, moe, vlm:
    ``k`` and ``v`` per layer.  ssm: each Mamba2 layer's f32 SSD state
    ``ssm_h`` and conv tail ``ssm_conv``.  Hybrid: both, Mamba2 layers on
    (group, layer) and ``k``/``v`` per group."""
    _check_family(cfg, "init_cache_specs")
    kv, dh = cfg.n_kv_heads, cfg.d_head
    lead = _groups(cfg) if cfg.family == "hybrid" else (cfg.n_layers,)
    specs = {}
    if cfg.family in ("ssm", "hybrid"):
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        specs["ssm_h"] = CacheSpec(lead + (batch, cfg.ssm_heads, cfg.ssm_state,
                                           cfg.ssm_head_dim), torch.float32)
        specs["ssm_conv"] = CacheSpec(lead + (batch, cfg.conv_width - 1,
                                              conv_dim), dtype)
    if cfg.family != "ssm":
        specs["k"] = CacheSpec(lead[:1] + (batch, max_seq, kv, dh), dtype)
        specs["v"] = CacheSpec(lead[:1] + (batch, max_seq, kv, dh), dtype)
    specs["index"] = CacheSpec((), torch.int32)
    return specs


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
    """An attention + FFN block on one token; writes its K and V into
    ``ck``/``cv`` at ``index``, in place."""
    a_out, _, _ = att.attn_decode(rms_norm(x, lp["ln1"]), lp["attn"], cfg,
                                  ck, cv, index, positions)
    h = x + a_out
    return h + _ffn(rms_norm(h, lp["ln2"]), lp, cfg)


def _mamba_decode(x, lp, cfg: Config, cache, idx):
    """A Mamba2 block on one token: updates its SSD state in
    ``cache["ssm_h"]`` at ``idx`` in place and returns (output, new conv
    tail)."""
    out, (h_new, conv_new) = ssm_mod.ssm_decode(
        rms_norm(x, lp["ln"]), lp["ssm"], cfg,
        (cache["ssm_h"][idx], cache["ssm_conv"][idx]))
    cache["ssm_h"][idx] = h_new
    return x + out, conv_new


def decode_step(params, cfg: Config, cache, token, positions=None):
    """One decode step: token (B, 1) -> (logits (B, V), new cache).

    ``k``, ``v`` and ``ssm_h`` are updated in place (the reference returns
    new arrays; copying them per token would move the whole cache); the
    returned dict holds the same tensors, the new ``ssm_conv`` and
    ``index + 1``."""
    _check_family(cfg, "decode_step")
    x = _embed(params, cfg, token)                      # (B, 1, D)
    index = int(cache["index"])
    if positions is None:
        positions = default_positions(cfg, token.shape[0], 1, x.device) + index
    new = {"index": index + 1}
    convs = []
    for kind, idx, lp, lcfg in _layers(params, cfg):
        if kind == "attn":
            x = _attn_block_decode(x, lp, lcfg, cache["k"][idx],
                                   cache["v"][idx], index, positions)
        else:
            x, conv = _mamba_decode(x, lp, lcfg, cache, idx)
            convs.append(conv)
    if convs:
        new["ssm_conv"] = torch.stack(convs).reshape(cache["ssm_conv"].shape)
    return _logits(x, params)[:, 0], dict(cache, **new)


def prefill(params, cfg: Config, tokens, max_seq: int, positions=None,
            cache_dtype=torch.bfloat16):
    """Prefill the decode cache from a full prompt: the full-sequence
    forward that also emits each Mamba2 layer's final SSD state and conv
    tail and each attention layer's K/V (padded to ``max_seq``).  Returns
    (last-position logits (B, V), cache); the cache's tensors are in
    ``cache_dtype``, except ``ssm_h`` (f32)."""
    _check_family(cfg, "prefill")
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prefill: a {s}-token prompt does not fit a "
                         f"{max_seq}-token cache")
    x = _embed(params, cfg, tokens)
    if positions is None:
        positions = default_positions(cfg, b, s, x.device)
    cache = init_cache(cfg, b, max_seq, cache_dtype, x.device)
    x = _run_stack(x, params, cfg, positions, cache)
    cache["index"] = s
    return _logits(x[:, -1], params), cache
