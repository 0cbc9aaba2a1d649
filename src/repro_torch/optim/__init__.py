"""Optimizers of the port."""
from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
