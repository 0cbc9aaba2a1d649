"""PEPS state and operator application (paper Sections II-C, III-A, IV-A).

Counterpart of ``repro.core.peps``; the leg-ordering diagram there holds
here too.  Site tensor layout ``(p, u, l, d, r)`` — physical, up, left,
down, right; grid site ``(i, j)`` (row-major) holds qubit ``i*ncol + j``;
boundary bonds have dimension 1.

Two-site operator application:

* ``DirectUpdate`` — contract the full theta and einsumsvd it (Eq. 4);
* ``QRUpdate``     — Alg. 1: QR both sites first (Gram factorization of
  Alg. 5, or LAPACK QR), einsumsvd the small Rs, re-absorb the Q factors;
* ``FullUpdate``   — the environment-aware full update
  (:mod:`repro_torch.core.full_update`).

Any other update option raises the reference's ``TypeError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import gates as _gates
from repro_torch.core.einsumsvd import DirectSVD, einsumsvd
from repro_torch.core.keys import TorchKey
from repro_torch.core.orthogonalize import gram_qr, reshape_qr
from repro_torch.device import resolve_device


class PEPS:
    """An nrow x ncol grid of site tensors (p, u, l, d, r).

    ``log_scale`` (a float or a 0-dim tensor) rides along so that site
    tensors can be renormalized without losing track of amplitudes."""

    def __init__(self, sites: List[List[torch.Tensor]], log_scale=0.0):
        self.sites = sites
        self.log_scale = log_scale

    @property
    def nrow(self) -> int:
        return len(self.sites)

    @property
    def ncol(self) -> int:
        return len(self.sites[0])

    @property
    def nsites(self) -> int:
        return self.nrow * self.ncol

    @property
    def dtype(self) -> torch.dtype:
        return self.sites[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.sites[0][0].device

    def copy(self) -> "PEPS":
        return PEPS([[t for t in row] for row in self.sites], self.log_scale)

    def site(self, flat_idx: int) -> torch.Tensor:
        return self.sites[flat_idx // self.ncol][flat_idx % self.ncol]

    def coords(self, flat_idx: int) -> Tuple[int, int]:
        return flat_idx // self.ncol, flat_idx % self.ncol

    def max_bond(self) -> int:
        return max(max(t.shape[1:]) for row in self.sites for t in row)

    def conj(self) -> "PEPS":
        return PEPS([[t.conj() for t in row] for row in self.sites],
                    self.log_scale)


def scale_by(val: torch.Tensor, log_scale, factor: float = 1.0) -> torch.Tensor:
    """``val * exp(factor * log_scale)`` in ``val``'s dtype and device."""
    if isinstance(log_scale, torch.Tensor):
        return val * torch.exp(factor * log_scale).to(val.device, val.dtype)
    return val * math.exp(factor * log_scale)


def computational_basis(bits: np.ndarray, dtype=torch.complex128,
                        device=None) -> PEPS:
    """The product state ``|bits>`` as a bond-dimension-1 PEPS."""
    device = resolve_device(device)
    bits = np.asarray(bits)
    nrow, ncol = bits.shape
    sites = []
    for i in range(nrow):
        row = []
        for j in range(ncol):
            t = torch.zeros((2, 1, 1, 1, 1), dtype=dtype, device=device)
            t[int(bits[i, j])] = 1.0
            row.append(t)
        sites.append(row)
    return PEPS(sites)


def computational_zeros(nrow: int, ncol: int, dtype=torch.complex128,
                        device=None) -> PEPS:
    """|0...0> as a bond-dimension-1 PEPS."""
    return computational_basis(np.zeros((nrow, ncol), dtype=int), dtype,
                               device)


def random_peps(nrow: int, ncol: int, bond: int, generator: torch.Generator,
                phys: int = 2, dtype=torch.complex128, device=None) -> PEPS:
    """Random PEPS with uniform interior bond dimension (edges are 1),
    normal entries scaled by ``1/sqrt(size)``, drawn from ``generator``
    (which must live on ``device``)."""
    device = resolve_device(device)
    real = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32
    sites = []
    for i in range(nrow):
        row = []
        for j in range(ncol):
            shape = (phys, 1 if i == 0 else bond, 1 if j == 0 else bond,
                     1 if i == nrow - 1 else bond, 1 if j == ncol - 1 else bond)
            t = torch.randn(shape, generator=generator, dtype=real, device=device)
            if dtype.is_complex:
                t = torch.complex(t, torch.randn(shape, generator=generator,
                                                 dtype=real, device=device))
            row.append(t.to(dtype) / math.sqrt(math.prod(shape)))
        sites.append(row)
    return PEPS(sites)


def random_onelayer(nrow: int, ncol: int, bond: int,
                    generator: torch.Generator, dtype=torch.complex128,
                    device=None) -> List[List[torch.Tensor]]:
    """Random PEPS *without physical indices* — (u, l, d, r) tensors."""
    p = random_peps(nrow, ncol, bond, generator, phys=1, dtype=dtype,
                    device=device)
    return [[t[0] for t in row] for row in p.sites]


# ---------------------------------------------------------------------------
# Update options
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DirectUpdate:
    """Contract full theta then einsumsvd (Eq. 4)."""
    rank: int
    svd: object = DirectSVD()


@dataclasses.dataclass(frozen=True)
class QRUpdate:
    """Alg. 1 (QR-SVD).  ``gram=True`` orthogonalizes with Alg. 5 (Gram
    factorization), ``gram=False`` with matricize + LAPACK QR."""
    rank: int
    svd: object = DirectSVD()
    gram: bool = True


@dataclasses.dataclass(frozen=True)
class FullUpdate:
    """Environment-aware full update (Lubasch et al., arXiv:1405.3259).

    The bond truncation is optimized in the metric of the two-site
    neighborhood environment, built from cached row environments and a
    left/right strip contraction (:mod:`repro_torch.core.full_update`).

    rank:       truncated bond dimension.
    svd:        einsumsvd engine of the ALS seed split.
    chi:        boundary bond dimension of the row environments.
    env_svd:    einsumsvd engine of the environment sweeps.
    als_iters:  number of ALS sweeps.
    als_eps:    relative Tikhonov regularization of the ALS normal matrices.
    positive:   hermitize and eigenvalue-clamp the bond environment.
    env_refresh_every: in ``ite.ite_run``, refresh the cached row
                environments every N gate applications; they are refreshed
                regardless when a bond has grown since the cached sweep.
    env_contract: contraction option of the environment sweeps, overriding
                ``(chi, env_svd)`` when set: a ``BMPS``, or a
                :class:`~repro_torch.core.distributed.DistributedBMPS` to run
                the row-environment sweeps column-sharded across devices
                (the same values, the levels bit for bit).
    """
    rank: int
    svd: object = DirectSVD()
    chi: int = 16
    env_svd: object = DirectSVD()
    als_iters: int = 6
    als_eps: float = 1e-12
    positive: bool = True
    env_refresh_every: int = 1
    env_contract: object = None

    def __post_init__(self):
        from repro_torch.core.bmps import BMPS
        from repro_torch.core.distributed import DistributedBMPS
        if self.env_contract is not None and \
                not isinstance(self.env_contract, (BMPS, DistributedBMPS)):
            raise TypeError(
                f"env_contract={type(self.env_contract).__name__}: expected "
                f"a BMPS or DistributedBMPS contraction option")


def check_update(update) -> None:
    """Validate a two-site update option (single source of the accepted set)."""
    if not isinstance(update, (DirectUpdate, QRUpdate, FullUpdate)):
        raise TypeError(
            f"unknown two-site update option {type(update).__name__!r}: "
            "expected DirectUpdate, QRUpdate, or FullUpdate")


# ---------------------------------------------------------------------------
# Operator application
# ---------------------------------------------------------------------------

def apply_single(state: PEPS, g, flat_site: int) -> PEPS:
    """One-site operator (Eq. 3) — contraction with the physical index."""
    i, j = state.coords(flat_site)
    t = state.sites[i][j]
    new = state.copy()
    new.sites[i][j] = torch.einsum("pq,quldr->puldr", _gates.as_tensor(g, t), t)
    return new


def _two_site_horizontal(a, b, g, update, key):
    """Core update for neighbouring sites in a row. a:(p,u,l,d,k) b:(q,U,k,D,R).

    Returns (new_a, new_b) with the shared bond truncated to update.rank."""
    rank = update.rank
    if isinstance(update, DirectUpdate):
        left, right = einsumsvd(update.svd, [g, a, b],
                                ["xypq", "puldk", "qUkDR"],
                                row="xuld", col="yUDR",
                                rank=rank, absorb="both", key=key)
        return left, right.movedim(0, 2)             # (m,y,U,D,R) -> (y,U,m,D,R)
    check_update(update)
    qr = gram_qr if update.gram else reshape_qr
    # Bring the small modes (p, k) last; QR over them.
    qa, ra = qr(a.permute(1, 2, 3, 0, 4), 2)        # qa:(u,l,d,α,β) ra:(α,β,p,k)
    qb, rb = qr(b.permute(1, 3, 4, 0, 2), 2)        # qb:(U,D,R,γ,δ) rb:(γ,δ,q,k)
    left, right = einsumsvd(update.svd, [g, ra, rb],
                            ["xypq", "abpk", "cdqk"],
                            row="xab", col="ycd",
                            rank=rank, absorb="both", key=key)
    new_a = torch.einsum("uldab,xabm->xuldm", qa, left)
    new_b = torch.einsum("UDRcd,mycd->yUmDR", qb, right)
    return new_a, new_b


def _apply_two_site_adjacent(state: PEPS, g: torch.Tensor, s0, s1, update,
                             key, envs=None) -> PEPS:
    if isinstance(update, FullUpdate):
        # the neighborhood environment is orientation-specific, so the full
        # update handles both orientations itself
        from repro_torch.core import full_update as _fu
        return _fu.full_update_bond(state, g, s0, s1, update, key, envs=envs)
    (i0, j0), (i1, j1) = s0, s1
    new = state.copy()
    if i0 == i1 and j1 == j0 + 1:                     # horizontal, left-right
        na, nb = _two_site_horizontal(state.sites[i0][j0], state.sites[i1][j1],
                                      g, update, key)
        new.sites[i0][j0], new.sites[i1][j1] = na, nb
    elif j0 == j1 and i1 == i0 + 1:                   # vertical, top-bottom
        # a's (d<->r) and b's (u<->l) swaps turn the vertical bond into the
        # canonical horizontal layout
        a = state.sites[i0][j0].permute(0, 1, 2, 4, 3)
        b = state.sites[i1][j1].permute(0, 2, 1, 3, 4)
        na, nb = _two_site_horizontal(a, b, g, update, key)
        new.sites[i0][j0] = na.permute(0, 1, 2, 4, 3)
        new.sites[i1][j1] = nb.permute(0, 2, 1, 3, 4)
    elif (i0 == i1 and j1 == j0 - 1) or (j0 == j1 and i1 == i0 - 1):
        # reversed orientation: swap the two qubits of the gate
        return _apply_two_site_adjacent(state, g.permute(1, 0, 3, 2), s1, s0,
                                        update, key)
    else:
        raise ValueError(f"sites {s0}, {s1} are not adjacent")
    return new


def _swap_path(s0: Tuple[int, int], s1: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Lattice path from s1's position to a neighbour of s0 (row then column)."""
    (i0, j0), (i1, j1) = s0, s1
    path = [(i1, j1)]
    i, j = i1, j1
    while (i != i0) if j != j0 else (abs(i - i0) > 1):
        i += 1 if i0 > i else -1
        path.append((i, j))
    while abs(j - j0) > 1:
        j += 1 if j0 > j else -1
        path.append((i, j))
    return path


def _adjacent(s0, s1) -> bool:
    return abs(s0[0] - s1[0]) + abs(s0[1] - s1[1]) == 1


def apply_operator(state: PEPS, g, flat_sites: Sequence[int],
                   update: Optional[object] = None, key=None,
                   envs=None) -> PEPS:
    """Apply a 1- or 2-site operator on arbitrary sites.

    Non-adjacent two-site operators are routed with SWAP chains (paper
    Section II-C1); each SWAP uses the same truncating update.  With
    ``key=None`` the key is seeded, as in the reference, by the XOR of 17
    and the site indices.

    ``envs`` (FullUpdate only): cached ``(top, bottom)`` row environments to
    truncate against; omitted, they are recomputed from the current state
    per bond.  Along a SWAP chain the same environments are reused."""
    if key is None:
        key = TorchKey(int(np.bitwise_xor.reduce(
            np.asarray([17, *flat_sites], dtype=np.uint32))))
    if len(flat_sites) == 1:
        return apply_single(state, g, flat_sites[0])
    if len(flat_sites) != 2:
        raise ValueError("only 1- and 2-site operators are supported")
    if update is None:
        update = QRUpdate(rank=max(4, state.max_bond()))
    check_update(update)
    like = state.sites[0][0]
    g = _gates.as_tensor(g, like)

    s0, s1 = state.coords(flat_sites[0]), state.coords(flat_sites[1])
    if _adjacent(s0, s1):
        return _apply_two_site_adjacent(state, g, s0, s1, update, key, envs)

    # SWAP-chain routing: walk s1 next to s0, apply, walk back.
    path = _swap_path(s0, s1)
    swap = _gates.as_tensor(_gates.SWAP, like)
    keys = iter(key.split(2 * len(path) + 1))
    for a, b in zip(path[:-1], path[1:]):
        state = _apply_two_site_adjacent(state, swap, a, b, update, next(keys),
                                         envs)
    state = _apply_two_site_adjacent(state, g, s0, path[-1], update,
                                     next(keys), envs)
    for a, b in zip(reversed(path[1:]), reversed(path[:-1])):
        state = _apply_two_site_adjacent(state, swap, a, b, update, next(keys),
                                         envs)
    return state


def normalize_sites(state: PEPS) -> PEPS:
    """Rescale every site tensor to unit max-|entry|, tracking log_scale."""
    new_sites = []
    log_scale = state.log_scale
    for row in state.sites:
        new_row = []
        for t in row:
            s = t.abs().max()
            s = torch.where(s == 0, torch.ones_like(s), s)
            new_row.append(t / s)
            log_scale = log_scale + torch.log(s)
        new_sites.append(new_row)
    return PEPS(new_sites, log_scale)


# ---------------------------------------------------------------------------
# Exact contraction (reference paths for small grids)
# ---------------------------------------------------------------------------

def to_statevector(state: PEPS) -> torch.Tensor:
    """Exact contraction to a (2,)*n state tensor (small grids only)."""
    nrow, ncol = state.nrow, state.ncol
    # boundary axes: [phys (row-major so far)] + [down bond per column]
    bound = torch.ones((1,) * ncol, dtype=state.dtype, device=state.device)
    n_phys = 0
    for i in range(nrow):
        # insert l_run (dim 1): [phys] + [l_run] + [u_0..u_{ncol-1}]
        bound = bound.reshape(bound.shape[:n_phys] + (1,) + bound.shape[n_phys:])
        for j in range(ncol):
            t = state.sites[i][j]  # (p,u,l,d,r)
            l_ax = n_phys + j
            bound = torch.tensordot(bound, t, dims=([l_ax, l_ax + 1], [2, 1]))
            # move the appended (p, d, r) to [phys.. p][d_new.. d][r_run]
            nb = bound.dim()
            bound = bound.movedim((nb - 3, nb - 2, nb - 1),
                                  (n_phys, n_phys + 1 + j, n_phys + 2 + j))
            n_phys += 1
        bound = bound.reshape(bound.shape[:-1])  # drop r_run (dim 1)
    bound = bound.reshape(bound.shape[:n_phys])   # drop the final down bonds
    return scale_by(bound, state.log_scale)


def amplitude_exact(state: PEPS, bits: np.ndarray) -> torch.Tensor:
    """<bits|psi> by exact one-layer boundary contraction (no truncation)."""
    bits = np.asarray(bits).reshape(state.nrow, state.ncol)
    bound = torch.ones((1,) * state.ncol, dtype=state.dtype,
                       device=state.device)
    for i in range(state.nrow):
        bound = bound.reshape((1,) + bound.shape)  # l_run axis in front
        for j in range(state.ncol):
            t = state.sites[i][j][int(bits[i, j])]  # (u,l,d,r)
            bound = torch.tensordot(bound, t, dims=([j, j + 1], [1, 0]))
            nb = bound.dim()
            bound = bound.movedim((nb - 2, nb - 1), (j, j + 1))
        bound = bound.reshape(bound.shape[:-1])  # drop r_run (dim 1)
    return scale_by(bound.reshape(()), state.log_scale)
