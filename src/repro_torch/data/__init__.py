"""Deterministic synthetic token data for the LM launcher."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
