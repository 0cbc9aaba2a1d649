"""Carry PEPS state, row environments, LM parameters and decode caches
across packages as numpy arrays.

``peps_from_numpy`` takes the site tensors of a PEPS as nested lists of
numpy arrays (for the JAX package's PEPS: ``np.asarray`` of each site) and
builds the port's :class:`~repro_torch.core.peps.PEPS`; ``peps_to_numpy``
goes the other way.  ``envs_from_numpy`` / ``envs_to_numpy`` do the same
for a ``(top, bottom)`` pair of cached row environments (lists of levels,
each a list of ``(l, d_bra, d_ket, r)`` tensors), the input of the full
update.  ``lm_params_from_numpy`` / ``lm_params_to_numpy`` and
``cache_from_numpy`` / ``cache_to_numpy`` do the same for an LM parameter
tree and a decode cache: nested dicts in the reference's keys and shapes.
They walk whatever keys the tree holds, so one pair serves every ported
family: the dense tree (``layers``) and its ``k``/``v`` cache, the ssm tree
(``ssm_ln``, ``ssm``) and its ``ssm_h``/``ssm_conv`` cache, and the hybrid
tree and cache, which hold both kinds.  ``opt_state_from_numpy`` /
``opt_state_to_numpy`` carry an AdamW state (``mu`` and ``nu`` trees in
the parameters' keys, and the step ``count``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.peps import PEPS
from repro_torch.device import resolve_device
from repro_torch.models.common import distribute


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


def envs_from_numpy(envs, *, dtype=None, device=None):
    """Port ``(top, bottom)`` row environments from nested lists of numpy
    arrays; ``dtype=None`` keeps each array's dtype."""
    device = resolve_device(device)
    return tuple([[torch.tensor(np.asarray(t), dtype=dtype, device=device)
                   for t in level] for level in side] for side in envs)


def envs_to_numpy(envs):
    """``(top, bottom)`` as nested lists of numpy arrays."""
    return tuple([[t.detach().cpu().numpy() for t in level] for level in side]
                 for side in envs)


def _tensor(arr, dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":    # numpy has no bf16: widen, exactly
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=dtype or torch.bfloat16)
    return torch.tensor(arr, dtype=dtype, device=device)


def _array(t: torch.Tensor) -> np.ndarray:
    """A copy: a CPU tensor's ``.numpy()`` shares its memory, and decode
    updates the cache in place."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def lm_params_from_numpy(tree, *, dtype=None, device=None) -> Dict[str, Any]:
    """Port parameter tree from nested dicts of numpy arrays (for the JAX
    package: ``np.asarray`` of each leaf; ml_dtypes bfloat16 arrays are
    read exactly).  ``dtype=None`` keeps each array's dtype."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, dtype=dtype, device=device)
                for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def lm_params_to_numpy(tree) -> Dict[str, Any]:
    """Nested dicts of numpy arrays; bfloat16 leaves come back as float32
    (exactly: numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    return _array(tree)


def cache_from_numpy(cache, *, device=None, shardings=None) -> Dict[str, Any]:
    """Port decode cache from the reference's, for any family's keys: each
    array keeps its dtype and ``index`` becomes a Python int.  With
    ``shardings`` (``ModelBundle.cache_shardings``) each entry is a
    ``DTensor`` placed by it, every rank keeping its block of the same
    arrays."""
    device = resolve_device(device)
    out = {k: int(np.asarray(v)) if k == "index" else _tensor(v, None, device)
           for k, v in cache.items()}
    if shardings is not None:
        out.update({k: distribute(v, shardings[k]) for k, v in out.items()
                    if k != "index"})
    return out


def cache_to_numpy(cache) -> Dict[str, Any]:
    """Numpy arrays (bfloat16 as float32) and ``index`` as an int32 scalar."""
    return {k: np.asarray(v, np.int32) if k == "index" else _array(v)
            for k, v in cache.items()}


def opt_state_from_numpy(state, *, device=None) -> Dict[str, Any]:
    """Port AdamW state from ``{"mu": tree, "nu": tree, "count": scalar}``
    of numpy arrays (the reference's ``adamw_init``/``adamw_update``
    layout); moments keep their dtype, ``count`` is an int32 scalar."""
    device = resolve_device(device)
    return {"mu": lm_params_from_numpy(state["mu"], device=device),
            "nu": lm_params_from_numpy(state["nu"], device=device),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=device)}


def opt_state_to_numpy(state) -> Dict[str, Any]:
    """``{"mu": tree, "nu": tree, "count": int32 scalar}`` of numpy
    arrays."""
    return {"mu": lm_params_to_numpy(state["mu"]),
            "nu": lm_params_to_numpy(state["nu"]),
            "count": np.asarray(int(state["count"]), np.int32)}
