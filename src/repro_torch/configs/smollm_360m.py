"""SmolLM-360M — small llama-arch dense [hf:HuggingFaceTB/SmolLM; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_head=64,
    d_ff=2560, vocab=49152,
    param_dtype=torch.bfloat16,
)
