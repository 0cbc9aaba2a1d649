"""Whisper-large-v3 — enc-dec backbone, conv frontend stubbed
[arXiv:2212.04356]."""
import torch

from repro_torch.models.common import Config

CONFIG = Config(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_head=64, d_ff=5120, vocab=51866, enc_frames=1500,
    param_dtype=torch.bfloat16,
)
