"""IBM Granite-8B (code) — llama-arch dense [arXiv:2405.04324; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=49152,
    param_dtype=torch.bfloat16,
)
