"""Cached row environments for PEPS expectation values (paper Section IV-B).

Counterpart of ``repro.core.environments``.  Two full sweeps (top-down and
bottom-up) produce ``top[i]`` / ``bottom[i]`` for all ``i``; each local-term
expectation then only costs a short strip contraction.  Environment MPS
tensors are in two-layer boundary layout ``(l, d_bra, d_ket, r)``; bottom
environments face upward.  :func:`strip_boundary` gives the full update its
left/right neighborhood environments from the cached rows.  The one-layer
prefix environments of the <x|psi> amplitude network
(:func:`onelayer_prefix_environment`) are the serving engine's amplitude
prefixes.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import planner
from repro_torch.core.bmps import BMPS, _check_single_device, \
    _distributed_module
from repro_torch.core.engines import get_engine
from repro_torch.core.engines.zipup import _keys, trivial_twolayer_boundary
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
    length ``nrow+1`` — closing ``top[nrow]`` gives <bra|ket>.

    A :class:`~repro_torch.core.distributed.DistributedBMPS` runs the sweep
    column-sharded with this key and gathers every level to its first
    device, bit for bit these levels, so ``expectation``'s strips and the
    full update read them unchanged."""
    key = key_or_default(key, DEFAULT_KEY_SEED)
    dist = _distributed_module(option)
    if dist is not None:
        return dist.top_environments(bra_rows, ket_rows, option, key)
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


# ---------------------------------------------------------------------------
# One-layer prefix environments (the serving engine's amplitude prefixes)
# ---------------------------------------------------------------------------
#
# The <x|psi> network is one-layer: site (i, j) is the PEPS tensor projected
# on bit x[i, j].  Its top boundary environments depend only on the bits of
# the rows absorbed so far, so every query with the same bit prefix shares
# them.

def onelayer_top_environments(rows, option: BMPS, key=None,
                              nrow_total: int = None) -> List[List[torch.Tensor]]:
    """Boundary-MPS levels of a one-layer (u,l,d,r) grid, top-down:
    ``env[k]`` is the boundary MPS after absorbing rows ``0..k`` (tensors
    ``(l, d, r)``).  Row ``i`` takes ``keys[i]`` of one
    ``_keys(key, max(nrow, 2))`` split, as in
    :func:`repro_torch.core.bmps.contract_onelayer`, so closing ``env[-1]``
    repeats the per-query contraction bit for bit.  ``nrow_total`` sets
    the split length when ``rows`` is the prefix of a taller grid.  Only a
    single-device :class:`BMPS` serves (the reference's ``TypeError``)."""
    _check_single_device(option, "onelayer prefix environments")
    eng = get_engine(option.engine)
    nrow = nrow_total if nrow_total is not None else len(rows)
    keys = _keys(key, max(nrow, 2))
    svec = [t.reshape(t.shape[1], t.shape[2], t.shape[3]) for t in rows[0]]
    envs = [svec]
    for i in range(1, len(rows)):
        svec = eng.absorb_onelayer(svec, rows[i], option.chi, option.svd,
                                   keys[i])
        envs.append(svec)
    return envs


def onelayer_prefix_environment(state, prefix_bits, option: BMPS,
                                key=None) -> List[torch.Tensor]:
    """Boundary MPS of rows ``0..len(prefix_bits)-1`` of <x|psi>
    (``prefix_bits``: per-row bit sequences, typically rows ``0..nrow-2``).
    An empty prefix (a one-row state) gives the trivial boundary: ``ncol``
    ``(1, 1, 1)`` ones on the state's device, in its dtype."""
    ncol = state.ncol
    if len(prefix_bits) == 0:
        return [torch.ones((1, 1, 1), dtype=state.dtype, device=state.device)
                for _ in range(ncol)]
    rows = [[state.sites[i][j][int(prefix_bits[i][j])] for j in range(ncol)]
            for i in range(len(prefix_bits))]
    return onelayer_top_environments(rows, option, key,
                                     nrow_total=state.nrow)[-1]


# ---------------------------------------------------------------------------
# Strip boundaries (the full update's left/right neighborhood environments)
# ---------------------------------------------------------------------------
#
# A strip is [top_env; bra rows; ket rows; bottom_env], the object
# ``expectation.strip_value`` contracts to a scalar.  Here only the columns
# left (or right) of a cut are contracted, leaving the horizontal bonds at
# the cut open.  The boundary tensor's axes are
#
#     (top_bond, bra_bond_0, ket_bond_0, ..., bra_bond_{n-1}, ket_bond_{n-1},
#      bottom_bond)
#
# for an n-row strip.

def _absorb_strip_column(v, top_t, bra_ts, ket_ts, bot_t, from_left: bool):
    """Absorb one strip column into a boundary tensor ``v`` (the open bonds
    at the current cut, facing the column); returns the boundary at the
    next cut.  One planner path-cache entry per shape class."""
    n = len(bra_ts)
    fresh = itertools.count(1).__next__
    v_labels = [fresh() for _ in range(2 * n + 2)]
    args = [v, v_labels]
    t_new = fresh()
    up_bra, up_ket = fresh(), fresh()
    top_lab = ([v_labels[0], up_bra, up_ket, t_new] if from_left else
               [t_new, up_bra, up_ket, v_labels[0]])
    args += [top_t, top_lab]
    out = [t_new]
    for r in range(n):
        p = fresh()
        d_bra, d_ket = fresh(), fresh()
        n_bra, n_ket = fresh(), fresh()
        if from_left:
            args += [bra_ts[r].conj(), [p, up_bra, v_labels[1 + 2 * r], d_bra, n_bra]]
            args += [ket_ts[r], [p, up_ket, v_labels[2 + 2 * r], d_ket, n_ket]]
        else:
            args += [bra_ts[r].conj(), [p, up_bra, n_bra, d_bra, v_labels[1 + 2 * r]]]
            args += [ket_ts[r], [p, up_ket, n_ket, d_ket, v_labels[2 + 2 * r]]]
        out += [n_bra, n_ket]
        up_bra, up_ket = d_bra, d_ket
    b_new = fresh()
    bot_lab = ([v_labels[-1], up_bra, up_ket, b_new] if from_left else
               [b_new, up_bra, up_ket, v_labels[-1]])
    args += [bot_t, bot_lab]
    out.append(b_new)
    args.append(out)
    return planner.int_einsum(*args)


def strip_boundary(top_env, bottom_env, bra_rows, ket_rows, cut: int,
                   from_left: bool) -> torch.Tensor:
    """Boundary tensor of a strip at column ``cut``.

    ``from_left=True`` contracts columns ``[0, cut)`` (open bonds face
    right); ``from_left=False`` contracts columns ``[cut, ncol)`` (open
    bonds face left).  Strips are at most two rows high, so the boundary is
    exact (no truncation)."""
    n = len(bra_rows)
    t0 = top_env[0]
    v = torch.ones((1,) * (2 * n + 2), dtype=t0.dtype, device=t0.device)
    cols = range(cut) if from_left else range(len(top_env) - 1, cut - 1, -1)
    for c in cols:
        v = _absorb_strip_column(v, top_env[c], [row[c] for row in bra_rows],
                                 [row[c] for row in ket_rows], bottom_env[c],
                                 from_left)
    return v


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
