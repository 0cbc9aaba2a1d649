"""Cached row environments for PEPS expectation values (paper Section IV-B).

Counterpart of ``repro.core.environments``.  Two full sweeps (top-down and
bottom-up) produce ``top[i]`` / ``bottom[i]`` for all ``i``; each local-term
expectation then only costs a short strip contraction.  Environment MPS
tensors are in two-layer boundary layout ``(l, d_bra, d_ket, r)``; bottom
environments face upward.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core.bmps import BMPS, _check_option
from repro_torch.core.engines import get_engine
from repro_torch.core.engines.zipup import trivial_twolayer_boundary
from repro_torch.core.keys import key_or_default

#: Seed of the key used when an environment sweep is called with
#: ``key=None`` (the reference's value).
DEFAULT_KEY_SEED = 11


def trivial_env(ncol: int, dtype, device) -> List[torch.Tensor]:
    one = torch.ones((1, 1, 1, 1), dtype=dtype, device=device)
    return [one for _ in range(ncol)]


def _flip_rows(rows: Sequence[Sequence[torch.Tensor]]):
    """Vertical flip of a (p,u,l,d,r) grid: reverse rows, swap u<->d."""
    return [[t.permute(0, 3, 2, 1, 4) for t in row] for row in reversed(rows)]


def top_environments(bra_rows, ket_rows, option: BMPS,
                     key=None) -> List[List[torch.Tensor]]:
    """``top[i]`` = boundary MPS of rows ``0..i-1`` (``top[0]`` trivial);
    length ``nrow+1`` — closing ``top[nrow]`` gives <bra|ket>."""
    _check_option(option)
    key = key_or_default(key, DEFAULT_KEY_SEED)
    eng = get_engine(option.engine)
    nrow, ncol = len(bra_rows), len(bra_rows[0])
    t0 = bra_rows[0][0]
    keys = key.split(max(nrow, 2))
    envs = [trivial_env(ncol, t0.dtype, t0.device)]
    svec = trivial_twolayer_boundary(ncol, t0.dtype, t0.device)
    for i in range(nrow):
        svec = eng.absorb_twolayer(svec, bra_rows[i], ket_rows[i],
                                   option.chi, option.svd, keys[i])
        envs.append(svec)
    return envs


def row_environments(state, option: BMPS, key=None) -> Tuple[List, List]:
    """(top, bottom) environments of the <psi|psi> network of a PEPS.

    * ``top[i]``    covers rows ``0..i-1``       (len nrow+1)
    * ``bottom[i]`` covers rows ``i+1..nrow-1``  (len nrow)"""
    k1, k2 = key_or_default(key, 13).split(2)
    nrow = state.nrow
    top = top_environments(state.sites, state.sites, option, k1)
    flipped = _flip_rows(state.sites)
    bottom_sweep = top_environments(flipped, flipped, option, k2)
    bottom = [bottom_sweep[nrow - 1 - i] for i in range(nrow)]
    return top, bottom
