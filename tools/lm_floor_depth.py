#!/usr/bin/env python3
"""Where a served LM's bf16 rounding floor comes from, on the card.

    PYTHONPATH=src python3 tools/lm_floor_depth.py [--arch qwen2-vl-72b]
                                                   [--depths 4 8 16]

``chip_smoke.py``'s ``lm_serve`` phases measure each model's bf16 floor:
the plain bf16 prefill's last-position logits against the plain prefill
of the same bf16 weights read by f32 activations.  For ``--arch`` (the
served config of ``chip_smoke.lm_config``, random bf16 weights from
``chip_smoke.SEED``, the phase's 4 x 2,048-token prompt and positions)
this script prints, as JSON lines:

* ``floor``: the floor at the served depth and its four rows;
* ``hidden``: the relative gap of the bf16 hidden state from the f32 one
  (the prompt's last 64 positions) after each layer;
* ``variant``: the floor with SwiGLU's ``silu(g) * u`` taken in f32, and
  with the attention's Q scaled in f32 inside the plain version (two
  roundings the bf16 path makes that the reference's naive path does
  not), each patched into this process only;
* ``depth``: the floor at each of ``--depths`` layers (weights drawn anew
  at that depth);

and the card's ``nvidia-smi`` line.  About 60 s for Qwen2-VL-72B.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import flash_attention as KF  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build  # noqa: E402


def rows_gap(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()


def floor(params, cfg, tokens, pos):
    """(floor, its rows): plain bf16 vs plain f32 prefill logits."""
    bf16, f32 = (C.prefill_in(torch, T, "dense", params,
                              dataclasses.replace(cfg, act_dtype=act),
                              tokens, tokens.shape[1], positions=pos)[0]
                 for act in (torch.bfloat16, torch.float32))
    return C.logits_gap(torch, bf16, f32)[0], rows_gap(bf16, f32)


def hidden_gaps(params, cfg, tokens, pos):
    states = {}
    with C.sites_in("dense"):
        for act in (torch.bfloat16, torch.float32):
            c = dataclasses.replace(cfg, act_dtype=act)
            x, states[act] = T._embed(params, c, tokens), []
            for _, _, lp, lcfg in T._layers(params, c):
                x = T._attn_block(x, lp, lcfg, pos)
                states[act].append(x[:, -64:].float())
    return [((a - b).norm() / b.norm()).item()
            for a, b in zip(states[torch.bfloat16], states[torch.float32])]


def swiglu_f32(x, w_gate, w_up, w_down):
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g.float()) * u.float()).to(x.dtype) @ w_down.to(x.dtype)


def softmax_weights_q_f32(q, k, causal, kv_len=None):
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qs = q.float().reshape(b, hkv, hq // hkv, s, d) / d ** 0.5
    logits = torch.einsum("bkgsd,bktd->bkgst", qs, k.float())
    kj = torch.arange(sk, device=q.device)
    if causal:
        qi = torch.arange(s, device=q.device)
        logits = logits.masked_fill(qi[:, None] < kj[None, :], -1e30)
    return torch.softmax(logits, dim=-1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-vl-72b")
    ap.add_argument("--depths", type=int, nargs="*", default=[4, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_floor_depth: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, _ = C.lm_config(args.arch)
    tokens = torch.from_numpy(np.random.default_rng(C.SEED).integers(
        0, cfg.vocab, size=(C.LM_BATCH, C.LM_PROMPT))).cuda()
    pos = (C.vl_positions(torch, C.LM_BATCH, C.LM_PROMPT)
           if cfg.mrope_sections is not None else None)
    with torch.no_grad():
        params = build(cfg).init(C.SEED)
        gap, rows = floor(params, cfg, tokens, pos)
        print(json.dumps({"what": "floor", "arch": args.arch,
                          "n_layers": cfg.n_layers, "floor": gap,
                          "rows": rows}), flush=True)
        print(json.dumps({"what": "hidden", "by_layer": hidden_gaps(
            params, cfg, tokens, pos)}), flush=True)
        for name, module, attr, patch in (
                ("silu_u_f32", T, "swiglu", swiglu_f32),
                ("q_scale_f32", KF, "_softmax_weights",
                 softmax_weights_q_f32)):
            real = getattr(module, attr)
            setattr(module, attr, patch)
            try:
                gap, rows = floor(params, cfg, tokens, pos)
            finally:
                setattr(module, attr, real)
            print(json.dumps({"what": "variant", "variant": name,
                              "floor": gap, "rows": rows}), flush=True)
        del params
        for depth in args.depths:
            torch.cuda.empty_cache()
            c = dataclasses.replace(cfg, n_layers=depth)
            params = build(c).init(C.SEED)
            gap, rows = floor(params, c, tokens, pos)
            print(json.dumps({"what": "depth", "n_layers": depth,
                              "floor": gap, "rows": rows}), flush=True)
            del params
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
