"""Snowflake Arctic-480B — 128e top-2 MoE + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, d_expert_ff=4864, moe_dense_residual=True,
    param_dtype=torch.bfloat16,
)
