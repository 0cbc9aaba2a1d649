"""Mamba2-2.7B — attention-free SSD [arXiv:2405.21060]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    sub_quadratic=True,
    param_dtype=torch.bfloat16,
)
