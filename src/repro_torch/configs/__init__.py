"""Architecture registry: counterpart of ``repro.configs``.

``get(name)`` returns the full published Config; ``get_smoke(name)`` a
reduced same-family config for CPU tests.  The dense, ssm and hybrid
architectures are ported; the moe, vlm and encdec ones raise with the
``ROADMAP.md`` item that ports them.
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
    "zamba2-2.7b": "zamba2_2p7b",
    "mamba2-2.7b": "mamba2_2p7b",
}

# Not ported yet: the LM-substrate item of ROADMAP.md §1 that ports each
# family, and each architecture's family.
FAMILY_ITEMS = {
    "moe": "LM item 3 (moe family)",
    "vlm": "LM item 4 (vlm family)",
    "encdec": "LM item 5 (encdec family)",
}
PENDING = {
    "qwen3-moe-30b-a3b": "moe", "arctic-480b": "moe",
    "qwen2-vl-72b": "vlm", "whisper-large-v3": "encdec",
}


def get(name: str) -> Config:
    if name in PENDING:
        raise NotImplementedError(
            f"{name} is not ported to repro_torch yet: ROADMAP.md §1, "
            f"{FAMILY_ITEMS[PENDING[name]]}")
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}: expected one of {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG


def get_smoke(name: str) -> Config:
    """Reduced same-family config: small widths, few layers (the
    reference's overrides)."""
    cfg = get(name)
    overrides = dict(
        n_layers=2, d_model=64, d_ff=128, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16,
        param_dtype=cfg.param_dtype, act_dtype=cfg.act_dtype,
        remat=False,
    )
    if cfg.family in ("ssm", "hybrid"):
        overrides.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        overrides.update(n_layers=6, hybrid_group=3)
    return dataclasses.replace(cfg, **overrides)
