"""Qwen3-30B-A3B — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=0, vocab=151936, qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8, d_expert_ff=768, norm_topk=True,
    param_dtype=torch.bfloat16,
)
