"""Architecture registry: counterpart of ``repro.configs``.

``get(name)`` returns the full published Config; ``get_smoke(name)`` a
reduced same-family config for CPU tests.  Every architecture of the
reference is ported: the dense, moe, ssm, hybrid, vlm and encdec families.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.common import Config

ARCHS: List[str] = [
    "granite-8b",
    "qwen3-4b",
    "smollm-360m",
    "deepseek-coder-33b",
    "qwen3-moe-30b-a3b",
    "arctic-480b",
    "zamba2-2.7b",
    "qwen2-vl-72b",
    "mamba2-2.7b",
    "whisper-large-v3",
]

_MODULES = {
    "granite-8b": "granite_8b",
    "qwen3-4b": "qwen3_4b",
    "smollm-360m": "smollm_360m",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b",
    "arctic-480b": "arctic_480b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-2.7b": "mamba2_2p7b",
    "whisper-large-v3": "whisper_large_v3",
}


def get(name: str) -> Config:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}: expected one of {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG


def get_smoke(name: str) -> Config:
    """Reduced same-family config: small widths, few layers and experts
    (the reference's overrides)."""
    cfg = get(name)
    overrides = dict(
        n_layers=2, d_model=64, d_ff=128, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16,
        param_dtype=cfg.param_dtype, act_dtype=cfg.act_dtype,
        remat=False,
    )
    if cfg.family == "moe":
        overrides.update(n_experts=8, top_k=2, d_expert_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        overrides.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        overrides.update(n_layers=6, hybrid_group=3)
    if cfg.family == "encdec":
        overrides.update(n_enc_layers=2, enc_frames=16)
    if cfg.mrope_sections is not None:
        overrides.update(mrope_sections=(2, 3, 3))   # half of d_head 16
    return dataclasses.replace(cfg, **overrides)
