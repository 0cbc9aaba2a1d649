"""Zamba2-2.7B — Mamba2 blocks + shared attention [arXiv:2411.15242; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    hybrid_group=6, sub_quadratic=True,
    param_dtype=torch.bfloat16,
)
