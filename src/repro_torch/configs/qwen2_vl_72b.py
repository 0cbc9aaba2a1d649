"""Qwen2-VL-72B — M-RoPE decoder backbone; vision frontend stubbed
[arXiv:2409.12191; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=29568, vocab=152064, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    param_dtype=torch.bfloat16,
)
