"""Qwen3-4B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
    param_dtype=torch.bfloat16,
)
