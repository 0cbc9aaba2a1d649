"""DeepSeek-Coder-33B — deep llama-arch dense [arXiv:2401.14196; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=19200, vocab=32256,
    param_dtype=torch.bfloat16,
)
