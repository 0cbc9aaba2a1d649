"""PEPS ensembles over a device mesh — the ensemble half of
``repro.core.sharding``.

An *ensemble* is a batch of independent PEPS evolutions or contractions
(the VQE/ITE parameter sweeps of paper Section VI-D).  The reference
``vmap``s a step over the members and lets GSPMD split the member axis
over the mesh; here each member runs on its own device, one member after
another, and the member axis is split over the mesh by the reference's
rule (:func:`ensemble_sharding`).  Member ``i`` computes exactly what the
same step computes on it alone: placement never changes values.

Contracting **one** state too large for a device is the job of
:mod:`repro_torch.core.distributed` (column shards).  The cyclops half of
the reference (one bond axis of every site tensor over ``'model'``:
``site_sharding``, ``peps_shardings``, ``carry_model_constraint``) is not
ported: a non-``None`` ``constrain_carry`` raises naming ROADMAP PEPS
item 9.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import gates as G
from repro_torch.core.bmps import BMPS, contract_twolayer
from repro_torch.core.einsumsvd import RandomizedSVD
from repro_torch.core.peps import (PEPS, FullUpdate, QRUpdate,
                                   _apply_two_site_adjacent)


@dataclasses.dataclass(frozen=True)
class PEPSConfig:
    name: str = "peps-rqc"
    nrow: int = 8
    ncol: int = 8
    bond: int = 16            # evolution bond dimension r (RQC initial bond)
    chi: int = 64             # contraction bond dimension m
    ensemble: int = 32        # independent PEPS (VQE-style parameter sweep)
    dtype: object = torch.complex64


class EnsembleSharding(NamedTuple):
    """Where an ``(ensemble, ...)`` array's members live: ``axes`` are the
    mesh axes the member axis is split over (``()``: replicated), ``spec``
    the ``PartitionSpec`` counterpart (one entry per array axis) and
    ``devices[i]`` member ``i``'s device."""
    axes: Tuple[str, ...]
    spec: Tuple
    devices: Tuple[torch.device, ...]


def ensemble_sharding(mesh, ensemble: int, ndim: int) -> EnsembleSharding:
    """Split of an ``(ensemble, ...)`` member-batched array over ``mesh``.

    The member axis goes over **all** mesh axes when ``ensemble`` divides
    by the device count, else over the trailing mesh axis whose size
    divides it, else it is replicated (every member on the mesh's first
    device).  Trailing array axes are never split.  Chunk ``p`` of the
    member axis lands on the mesh cell whose index over the split axes is
    ``p`` in row-major order, at index 0 of the other axes."""
    sizes = mesh.shape
    names = list(mesh.axis_names)
    axes: Tuple[str, ...] = ()
    if mesh.size > 1 and ensemble % mesh.size == 0:
        axes = tuple(names)
    else:
        for a in reversed(names):
            if sizes[a] > 1 and ensemble % sizes[a] == 0:
                axes = (a,)
                break
    nchunks = int(np.prod([sizes[a] for a in axes])) if axes else 1
    per = ensemble // nchunks
    devices = []
    for i in range(ensemble):
        chunk = np.unravel_index(i // per, [sizes[a] for a in axes]) \
            if axes else ()
        cell = [0] * len(names)
        for a, c in zip(axes, chunk):
            cell[names.index(a)] = int(c)
        devices.append(mesh.devices[tuple(cell)])
    spec = (axes if len(axes) > 1 else (axes[0] if axes else None),) + \
        (None,) * (ndim - 1)
    return EnsembleSharding(axes, spec, tuple(devices))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_ensemble(tree, mesh, ensemble: int) -> list:
    """An optimizer-state tree of ``(ensemble, ...)`` tensors (dicts,
    lists, tuples) as its ``ensemble`` member trees, member ``i``'s slices
    on its :func:`ensemble_sharding` device."""
    devices = ensemble_sharding(mesh, ensemble, 1).devices
    return [_tree_map(lambda v, i=i: v[i].to(devices[i]), tree)
            for i in range(ensemble)]


def abstract_ensemble(cfg: PEPSConfig) -> PEPS:
    """The ensemble of ``random_peps(cfg.nrow, cfg.ncol, cfg.bond)`` states
    as ``meta`` tensors (shapes and dtype, no allocation)."""
    n, m, r = cfg.nrow, cfg.ncol, cfg.bond
    return PEPS([[torch.empty((cfg.ensemble, 2, 1 if i == 0 else r,
                               1 if j == 0 else r, 1 if i == n - 1 else r,
                               1 if j == m - 1 else r),
                              dtype=cfg.dtype, device="meta")
                  for j in range(m)] for i in range(n)])


# ---------------------------------------------------------------------------
# The step functions of one member (the reference's dry-run steps)
# ---------------------------------------------------------------------------

def _evolve_layer(state: PEPS, key, upd, envs_fn=None) -> PEPS:
    """iSWAP on all horizontal then vertical neighbour pairs with ``upd``;
    ``envs_fn(state, key)``, when given, makes the row environments once
    per sweep direction."""
    g = torch.as_tensor(G.ISWAP, dtype=state.dtype, device=state.device)
    nrow, ncol = state.nrow, state.ncol
    for pairs in (
        [((i, j), (i, j + 1)) for i in range(nrow)
         for j in range(0, ncol - 1, 2)],
        [((i, j), (i + 1, j)) for j in range(ncol)
         for i in range(0, nrow - 1, 2)],
    ):
        envs = None
        if envs_fn is not None:
            key, ek = key.split(2)
            envs = envs_fn(state, ek)
        for s0, s1 in pairs:
            key, sub = key.split(2)
            state = _apply_two_site_adjacent(state, g, s0, s1, upd, sub, envs)
    return state


def evolve_step(state: PEPS, key) -> PEPS:
    """One TEBD layer: iSWAP on all horizontal + vertical neighbour pairs,
    QR-SVD simple update with Gram orthogonalization (Alg. 1 + Alg. 5)."""
    bond = state.sites[1][1].shape[4]  # interior bond dim
    upd = QRUpdate(rank=bond, svd=RandomizedSVD(niter=1, oversample=4))
    return _evolve_layer(state, key, upd)


def evolve_step_full(state: PEPS, key, chi_env: int = 8) -> PEPS:
    """One TEBD layer with the environment-aware :class:`FullUpdate`; the
    row environments are made once per sweep direction."""
    from repro_torch.core import full_update as _fu
    from repro_torch.core.environments import row_environments
    bond = state.sites[1][1].shape[4]
    upd = FullUpdate(rank=bond, chi=chi_env,
                     svd=RandomizedSVD(niter=1, oversample=4), als_iters=2)
    envs_fn = lambda s, k: row_environments(s, _fu.env_option(upd), k)
    return _evolve_layer(state, key, upd, envs_fn)


def contract_step(state: PEPS, chi: int, key, gram_final: bool = False,
                  constrain_carry=None) -> torch.Tensor:
    """<psi|psi> via two-layer IBMPS (the paper's headline algorithm)."""
    if constrain_carry is not None:
        raise NotImplementedError(
            "constrain_carry: the cyclops bond sharding of the zip-up carry "
            "is not ported (ROADMAP PEPS item 9)")
    option = BMPS(chi, RandomizedSVD(niter=1, oversample=4,
                                     gram_final=gram_final))
    return contract_twolayer(state.sites, state.sites, option, key)


# ---------------------------------------------------------------------------
# Member after member: the reference's vmapped batched steps
# ---------------------------------------------------------------------------

def _member_devices(states: PEPS, ensemble: int, mesh) -> Sequence:
    if mesh is None:
        return [states.device] * ensemble
    return ensemble_sharding(mesh, ensemble, 1).devices


def _member(states: PEPS, i: int, device) -> PEPS:
    # a fresh copy, laid out as a state of its own: a GEMM may pick another
    # algorithm for an operand at another alignment
    return PEPS([[t[i].to(device, copy=True) for t in row]
                 for row in states.sites])


def _stack(members: Sequence[PEPS], device) -> PEPS:
    first = members[0]
    return PEPS([[torch.stack([m.sites[i][j].to(device) for m in members])
                  for j in range(first.ncol)] for i in range(first.nrow)])


def _batched(step, states: PEPS, keys, mesh, **kw):
    """``step(member, key_i, **kw)`` for every member of the stacked
    ``states``, member ``i`` on its mesh device (default: where ``states``
    live); the results in the input's layout."""
    ensemble = states.sites[0][0].shape[0]
    if len(keys) != ensemble:
        raise ValueError(f"{len(keys)} keys for {ensemble} members")
    devices = _member_devices(states, ensemble, mesh)
    out = [step(_member(states, i, devices[i]), key=keys[i], **kw)
           for i in range(ensemble)]
    if isinstance(out[0], PEPS):
        return _stack(out, states.device)
    return torch.stack([v.to(states.device) for v in out])


def batched_evolve(states: PEPS, keys, mesh=None) -> PEPS:
    """:func:`evolve_step` of every member; ``keys[i]`` is member ``i``'s
    key, ``mesh`` places the members (:func:`ensemble_sharding`)."""
    return _batched(evolve_step, states, keys, mesh)


def batched_evolve_full(states: PEPS, keys, chi_env: int = 8,
                        mesh=None) -> PEPS:
    """:func:`evolve_step_full` of every member."""
    return _batched(evolve_step_full, states, keys, mesh, chi_env=chi_env)


def batched_contract(states: PEPS, chi: int, keys, gram_final: bool = False,
                     constrain_carry=None, mesh=None) -> torch.Tensor:
    """:func:`contract_step` of every member: ``(ensemble,)`` norms."""
    return _batched(contract_step, states, keys, mesh, chi=chi,
                    gram_final=gram_final, constrain_carry=constrain_carry)
