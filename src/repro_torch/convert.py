"""Carry PEPS state across packages as numpy arrays.

``peps_from_numpy`` takes the site tensors of a PEPS as nested lists of
numpy arrays (for the JAX package's PEPS: ``np.asarray`` of each site) and
builds the port's :class:`~repro_torch.core.peps.PEPS`; ``peps_to_numpy``
goes the other way.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.peps import PEPS
from repro_torch.device import resolve_device


def peps_from_numpy(sites, log_scale: float = 0.0, *, dtype=None,
                    device=None) -> PEPS:
    """Port PEPS from nested lists of numpy ``(p, u, l, d, r)`` arrays;
    ``dtype=None`` keeps each array's dtype."""
    device = resolve_device(device)
    rows = [[torch.tensor(np.asarray(t), dtype=dtype, device=device)
             for t in row] for row in sites]
    return PEPS(rows, float(log_scale))


def peps_to_numpy(state: PEPS) -> Tuple[List[List[np.ndarray]], float]:
    """(sites as nested lists of numpy arrays, log_scale as a float)."""
    sites = [[t.detach().cpu().numpy() for t in row] for row in state.sites]
    return sites, float(state.log_scale)
