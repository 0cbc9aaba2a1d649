"""Column-sharded boundary contraction of one PEPS (paper Section V).

Counterpart of ``repro.core.distributed``.  One PEPS is sharded
**column-block-cyclically** across devices and the boundary-MPS zip-up
runs as a pipelined sweep over the column blocks: per row absorption only
*halo* tensors cross between neighbouring shards — the zip-up carry V
moving right, and one boundary-MPS tensor moving back left per block edge.
The PEPS columns, the boundary MPS and the einsumsvd work stay on their
shard's device.  :mod:`repro_torch.core.sharding` parallelizes *ensembles*
of independent states instead.

Layout
------
Columns are grouped into contiguous blocks of width ``block``, dealt to
the ``n_shards`` shards round-robin, shard ``s`` owning blocks ``s, s +
n_shards, ...``; shards beyond the device list wrap round-robin onto it::

    ncol=8, n_shards=4, block=1          ncol=8, n_shards=4, block=2
    col:    0  1  2  3  4  5  6  7      col:    0  1  2  3  4  5  6  7
    shard:  0  1  2  3  0  1  2  3      shard:  0  0  1  1  2  2  3  3

``block=None`` gives one contiguous block per shard.

Halo exchange (per row absorption)
----------------------------------
A row is absorbed block by block: (1) the carry ``V`` is copied to the next
block's device; (2) the einsumsvd at that block's first column emits the
boundary tensor of the previous block's last column, which is copied back
to its owner.  Both copies are ``Tensor.to(device, non_blocking=True)``: a
no-op when the two shards share a device, so one card moves no bytes.

Scheduling (``wavefront=``)
---------------------------
``"host"``: the host pipeline.  Blocks are dispatched in order from one
host thread, and PyTorch's asynchronous launches let shard ``s`` start row
``i+1`` while shard ``s+1`` still works on row ``i`` — as far as the host
is not held.  Each einsumsvd reads a value back to the host (the
regularized eigh's retry check, cuSOLVER's info), so on several cards the
pipeline mostly serializes.

``"spmd"`` and ``"auto"``: :func:`_sweep_rows` hands each run of
chi-saturated rows that :func:`repro_torch.core.spmd.plan_run` accepts to
the wavefront superstep (:func:`repro_torch.core.spmd.absorb_rows`: one
worker thread and one stream per shard, so a read-back holds its own
shard alone), and absorbs every other row (the bond ramp, the last row)
on the host pipeline, counted by ``spmd.stats()["rows_host"]``.  The
superstep's own contiguous split goes back to the column owners after
it.  ``"spmd"`` falls back to the superstep's single-shard plan where no
split exists and warns when a sweep never engaged it; ``"auto"`` engages
only where two of the plan's shards sit on distinct devices (as the
reference's does), so on one device it is the host pipeline.  Values
never depend on the mode.

Equivalence
-----------
For any ``(n_shards, block)`` the sweep performs the identical sequence of
einsumsvd calls with identical operands and keys as the single-device
``contract_*`` path; blocking only decides where each call runs.  Boundary
levels (:func:`top_environments`) are therefore bit for bit the
single-device ones on one device type; the closing scalar
(:func:`_final_scalar`) multiplies per-block partial chains and so differs
in the last bits.  The planner's signatures carry the device *type*, never
its index, so a sharded sweep after a single-device warm-up replays every
cached path and fused callable.

Usage: pass a :class:`DistributedBMPS` anywhere a
:class:`~repro_torch.core.bmps.BMPS` is accepted::

    opt = DistributedBMPS.for_mesh(peps_mesh(4), chi=64)
    norm_squared(state, opt)     # == norm_squared(state, BMPS(64)) to rounding
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import spmd
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
from repro_torch.core.engines import get_engine
from repro_torch.core.engines.zipup import (_keys, zipup_block,
                                            zipup_block_twolayer)
from repro_torch.core.keys import key_or_default
from repro_torch.core.precision import resolve_precision, wrap_svd
from repro_torch.launch.mesh import _device, visible_devices

WAVEFRONTS = ("host", "spmd", "auto")


# ---------------------------------------------------------------------------
# Column layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColumnLayout:
    """Block-cyclic assignment of ``ncol`` columns to ``n_shards`` shards."""
    ncol: int
    n_shards: int
    block: int

    def __post_init__(self):
        if self.ncol < 1 or self.n_shards < 1 or self.block < 1:
            raise ValueError(f"bad layout {self!r}")

    @property
    def n_blocks(self) -> int:
        return -(-self.ncol // self.block)

    def block_columns(self, b: int) -> range:
        return range(b * self.block, min((b + 1) * self.block, self.ncol))

    @property
    def blocks(self) -> List[Tuple[int, range]]:
        """``[(shard, columns), ...]`` in left-to-right sweep order."""
        return [(b % self.n_shards, self.block_columns(b))
                for b in range(self.n_blocks)]

    def owner(self, col: int) -> int:
        """Shard owning ``col`` (and its boundary-MPS tensor)."""
        return (col // self.block) % self.n_shards


# ---------------------------------------------------------------------------
# Contraction option
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistributedBMPS:
    """Contraction option: column-sharded boundary MPS, mirroring ``BMPS``.

    ``chi``, ``svd``, ``engine`` and ``precision`` mean what they do on
    :class:`~repro_torch.core.bmps.BMPS` (the svd option is wrapped by the
    precision policy at construction).  ``n_shards`` defaults to the number
    of devices, ``block`` to one contiguous block per shard.  ``devices``
    pins the shard -> device map; shards beyond it wrap round-robin, so any
    layout also runs, with the same values, on one device.  Left empty, it
    is every visible CUDA device for a CUDA state and the CPU for a CPU
    state (:meth:`resolve`); a state is never moved between the CPU and a
    card.  ``wavefront``: ``"host"`` runs the host pipeline, ``"spmd"``
    and ``"auto"`` hand the chi-saturated rows to the superstep of
    :mod:`repro_torch.core.spmd` (see the module docstring).  Engines
    without block structure (``supports_blocks=False``, e.g.
    ``"variational"``) absorb each row whole on the first device, between
    the sharded layouts."""
    chi: int
    svd: object = DirectSVD()
    n_shards: Optional[int] = None
    block: Optional[int] = None
    devices: Tuple = ()
    wavefront: str = "host"
    engine: object = "zipup"
    precision: object = "exact"

    def __post_init__(self):
        if self.wavefront not in WAVEFRONTS:
            raise ValueError(f"wavefront must be 'host', 'spmd' or 'auto', "
                             f"got {self.wavefront!r}")
        eng = get_engine(self.engine)  # fail fast on unknown engines
        if self.wavefront != "host" and not eng.supports_blocks:
            raise ValueError(
                f"wavefront={self.wavefront!r} requires a block-capable "
                f"boundary engine, but engine {eng.name!r} has "
                f"supports_blocks=False: use wavefront='host', which runs "
                f"such engines row-local")
        policy = resolve_precision(self.precision)
        object.__setattr__(self, "svd", wrap_svd(self.svd, policy))
        object.__setattr__(self, "devices",
                           tuple(_device(d) for d in self.devices))

    @classmethod
    def randomized(cls, chi: int, niter: int = 4, oversample: int = 8,
                   fused: bool = True, **kw) -> "DistributedBMPS":
        """Distributed IBMPS / two-layer IBMPS (``BMPS.randomized``)."""
        return cls(chi, svd=RandomizedSVD(niter=niter, oversample=oversample,
                                          fused=fused), **kw)

    @classmethod
    def for_mesh(cls, mesh, chi: int, batch_index: int = 0,
                 **kw) -> "DistributedBMPS":
        """Shard over the ``'col'`` axis of a
        :func:`~repro_torch.launch.mesh.peps_mesh`; on a ``('col',
        'batch')`` mesh, ``batch_index`` selects the column of devices
        this state contracts on (one ensemble member per batch slice)."""
        names = list(mesh.axis_names)
        if "col" in names:
            devs = np.moveaxis(np.asarray(mesh.devices), names.index("col"), 0)
            devs = devs.reshape(devs.shape[0], -1)
            devs = devs[:, batch_index % devs.shape[1]]
        else:
            devs = np.asarray(mesh.devices).reshape(-1)
        return cls(chi, devices=tuple(devs.tolist()),
                   n_shards=kw.pop("n_shards", len(devs)), **kw)

    def resolve(self, ncol: int, device=None) -> Tuple[ColumnLayout, Tuple]:
        """Concrete (layout, devices) for an ``ncol``-column lattice whose
        tensors live on ``device`` (its type picks the default devices;
        ``None`` means the card)."""
        kind = torch.device(device).type if device is not None else "cuda"
        devices = self.devices or visible_devices(kind)
        if any(d.type != kind for d in devices):
            raise ValueError(
                f"a state on {kind} cannot be sharded over "
                f"{[str(d) for d in devices]}: nothing moves between the "
                f"CPU and the card")
        n = self.n_shards if self.n_shards is not None else len(devices)
        n = max(1, min(n, ncol))
        block = self.block if self.block is not None else -(-ncol // n)
        return ColumnLayout(ncol, n, block), devices


# ---------------------------------------------------------------------------
# Placement helpers
# ---------------------------------------------------------------------------

def _shard_device(devices, shard: int) -> torch.device:
    return devices[shard % len(devices)]


def _owner_device(layout: ColumnLayout, devices, col: int) -> torch.device:
    return _shard_device(devices, layout.owner(col))


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: ``t`` itself when it is there already."""
    return t.to(device, non_blocking=True)


def put_columns(rows: Sequence[Sequence[torch.Tensor]], layout: ColumnLayout,
                devices) -> List[List[torch.Tensor]]:
    """Every column of a tensor grid on its owner shard's device (a tensor
    already there is kept, so re-sharding a placed grid is free)."""
    return [[_move(t, _owner_device(layout, devices, c))
             for c, t in enumerate(row)] for row in rows]


def gather_columns(cols: Sequence[torch.Tensor],
                   device) -> List[torch.Tensor]:
    """A list of per-column tensors on one device.  The sweeps gather to
    the option's first device (the reference's default device): the strip
    contractions of :mod:`repro_torch.core.expectation` and the full
    update read their environments there."""
    return [_move(t, device) for t in cols]


# ---------------------------------------------------------------------------
# Distributed row absorption (the halo exchange)
# ---------------------------------------------------------------------------

def _absorb_row(svec_cols, layout: ColumnLayout, devices, kernel,
                make_args, keys) -> List[torch.Tensor]:
    """One zip-up row absorption, block by block across the shards.

    ``kernel`` is one of the block kernels of
    :mod:`repro_torch.core.engines.zipup`; ``make_args(cols)`` supplies its
    per-block operands (already on the owner).  The carry moves forward
    one shard per block edge; the first boundary tensor a block emits
    moves back to the previous block's shard."""
    ncol = layout.ncol
    blocks = layout.blocks
    out_cols: List[Optional[torch.Tensor]] = [None] * ncol
    v = None
    for bi, (shard, cols) in enumerate(blocks):
        if v is not None:
            v = _move(v, _shard_device(devices, shard))   # halo: carry forward
        outs, v = kernel(v, [svec_cols[c] for c in cols], *make_args(cols),
                         [keys[c] for c in cols],
                         first=(bi == 0), last=(bi == len(blocks) - 1))
        start = cols[0] - 1 if bi > 0 else 0
        for k, t in enumerate(outs):
            out_cols[start + k] = t
    # halo: each block's first output is the previous block's last column
    for bi in range(1, len(blocks)):
        prev_shard, prev_cols = blocks[bi - 1]
        c = prev_cols[-1]
        out_cols[c] = _move(out_cols[c], _shard_device(devices, prev_shard))
    return out_cols


def _row_twolayer(svec_cols, bra_row, ket_row, option: DistributedBMPS,
                  layout, devices, key) -> List[torch.Tensor]:
    def kernel(v, svec, bra, ket, keys, first, last):
        return zipup_block_twolayer(v, svec, bra, ket, option.chi, option.svd,
                                    keys, first=first, last=last)
    make_args = lambda cols: ([bra_row[c] for c in cols],
                              [ket_row[c] for c in cols])
    return _absorb_row(svec_cols, layout, devices, kernel, make_args,
                       _keys(key, layout.ncol))


def _row_onelayer(svec_cols, row, option: DistributedBMPS, layout, devices,
                  key) -> List[torch.Tensor]:
    def kernel(v, svec, mpo, keys, first, last):
        return zipup_block(v, svec, mpo, option.chi, option.svd, keys,
                           first=first, last=last)
    make_args = lambda cols: ([row[c] for c in cols],)
    return _absorb_row(svec_cols, layout, devices, kernel, make_args,
                       _keys(key, layout.ncol))


def _sweep_rows(svec_cols, grids, option: DistributedBMPS, layout, devices,
                row_keys, kernel_name: str, collect: bool = False):
    """Absorb all rows of ``grids`` into ``svec_cols``, each run of rows
    that the superstep plans on :func:`repro_torch.core.spmd.absorb_rows`
    and every other row on the host pipeline (``"host"``: every row).

    ``grids`` is ``(rows,)`` one-layer or ``(bra_rows, ket_rows)``
    two-layer (the same list object twice for <psi|psi>); ``row_keys[i]``
    is row ``i``'s key, split into column keys alike on both paths.
    ``collect=True`` also returns every boundary level gathered to the
    first device (environment sweeps)."""
    eng = get_engine(option.engine)
    if not eng.supports_blocks:
        return _sweep_rows_rowlocal(eng, svec_cols, grids, option, layout,
                                    devices, row_keys, kernel_name, collect)
    nrow = len(grids[0])
    mode = option.wavefront
    kernel = None
    if mode != "host":
        kernel = spmd.TWO_LAYER if kernel_name == "twolayer" else \
            spmd.ONE_LAYER
    levels = []
    used_spmd = False
    i = 0
    while i < nrow:
        run, plan = 0, None
        if kernel is not None:
            run, plan = spmd.plan_run(kernel, svec_cols, grids, i, option.chi,
                                      option.svd, layout.n_shards, devices,
                                      mode)
        if run:
            slices = []
            for g in grids:
                if slices and g is grids[0]:
                    slices.append(slices[0])
                else:
                    slices.append([g[i + j] for j in range(run)])
            svec_cols, lv = spmd.absorb_rows(
                kernel, svec_cols, tuple(slices), option.chi, option.svd,
                plan, row_keys[i:i + run], devices, collect=collect)
            # back to the column owners (a no-op where the superstep's
            # split is the layout's)
            svec_cols = [_move(t, _owner_device(layout, devices, c))
                         for c, t in enumerate(svec_cols)]
            if collect:
                levels.extend(lv)
            used_spmd = True
            i += run
            continue
        if kernel_name == "twolayer":
            svec_cols = _row_twolayer(svec_cols, grids[0][i], grids[1][i],
                                      option, layout, devices, row_keys[i])
        else:
            svec_cols = _row_onelayer(svec_cols, grids[0][i], option, layout,
                                      devices, row_keys[i])
        if collect:
            levels.append(gather_columns(svec_cols, devices[0]))
        if kernel is not None:
            spmd.note_host_rows(1)
        i += 1
    if mode == "spmd" and not used_spmd and nrow > 0:
        warnings.warn(
            "wavefront='spmd' sweep never engaged the superstep (all rows "
            "were bond-ramp rows or the last row): the whole sweep ran on "
            "the host pipeline. Use wavefront='auto' to silence this.",
            stacklevel=3)
    return svec_cols, levels


def _sweep_rows_rowlocal(eng, svec_cols, grids, option: DistributedBMPS,
                         layout, devices, row_keys, kernel_name: str,
                         collect: bool):
    """Row-local sweep for engines without block kernels: each row is
    gathered to the first device, absorbed by the engine exactly as on the
    single-device path (same key), and the new boundary goes back to the
    column owners."""
    d0 = devices[0]
    levels = []
    for i in range(len(grids[0])):
        svec_g = gather_columns(svec_cols, d0)
        if kernel_name == "twolayer":
            bra_g = gather_columns(grids[0][i], d0)
            ket_g = (bra_g if grids[1] is grids[0]
                     else gather_columns(grids[1][i], d0))
            svec_g = eng.absorb_twolayer(svec_g, bra_g, ket_g, option.chi,
                                         option.svd, row_keys[i])
        else:
            svec_g = eng.absorb_onelayer(svec_g,
                                         gather_columns(grids[0][i], d0),
                                         option.chi, option.svd, row_keys[i])
        svec_cols = [_move(t, _owner_device(layout, devices, c))
                     for c, t in enumerate(svec_g)]
        if collect:
            levels.append(gather_columns(svec_cols, d0))
    return svec_cols, levels


def _final_scalar(svec_cols, layout: ColumnLayout, devices) -> torch.Tensor:
    """Close a fully absorbed boundary MPS (dangling axes all dim 1): one
    partial chain product per block on its shard, then the small per-block
    (l, r) matrices in order on the first device."""
    partials = []
    for _, cols in layout.blocks:
        acc = None
        for c in cols:
            t = svec_cols[c]
            mat = t.reshape(t.shape[0], t.shape[-1])
            acc = mat if acc is None else acc @ mat
        partials.append(acc)
    vec = torch.ones((1,), dtype=svec_cols[0].dtype, device=devices[0])
    for p in partials:
        vec = vec @ _move(p, devices[0])
    return vec.reshape(())


# ---------------------------------------------------------------------------
# Contraction entry points (dispatched to from repro_torch.core.bmps)
# ---------------------------------------------------------------------------

def _trivial_boundary(layout: ColumnLayout, devices, dtype):
    return [torch.ones((1, 1, 1, 1), dtype=dtype,
                       device=_owner_device(layout, devices, c))
            for c in range(layout.ncol)]


def contract_twolayer(bra_rows, ket_rows, option: DistributedBMPS,
                      key=None) -> torch.Tensor:
    """Column-sharded <bra|ket>; the single-device path's arithmetic."""
    nrow, ncol = len(bra_rows), len(bra_rows[0])
    t0 = bra_rows[0][0]
    layout, devices = option.resolve(ncol, t0.device)
    keys = _keys(key, max(nrow, 2))
    bra = put_columns(bra_rows, layout, devices)
    ket = bra if ket_rows is bra_rows else put_columns(ket_rows, layout, devices)
    svec = _trivial_boundary(layout, devices, t0.dtype)
    svec, _ = _sweep_rows(svec, (bra, ket), option, layout, devices,
                          keys[:nrow], "twolayer")
    return _final_scalar(svec, layout, devices)


def contract_onelayer(rows, option: DistributedBMPS, key=None) -> torch.Tensor:
    """Column-sharded Alg. 2 (one-layer) contraction to a scalar."""
    nrow, ncol = len(rows), len(rows[0])
    layout, devices = option.resolve(ncol, rows[0][0].device)
    keys = _keys(key, max(nrow, 2))
    rows_c = put_columns(rows, layout, devices)
    # initial boundary MPS = row 0 with u squeezed: (l, d, r)
    svec = [t.reshape(t.shape[1], t.shape[2], t.shape[3]) for t in rows_c[0]]
    svec, _ = _sweep_rows(svec, (rows_c[1:],), option, layout, devices,
                          keys[1:nrow], "onelayer")
    return _final_scalar(svec, layout, devices)


def top_environments(bra_rows, ket_rows, option: DistributedBMPS,
                     key=None) -> List[List[torch.Tensor]]:
    """Sharded sibling of
    :func:`repro_torch.core.environments.top_environments`: the boundary
    sweep runs column-sharded and each level is gathered to the option's
    first device, where the strip contractions that read environments
    run.  Levels equal the single-device ones bit for bit."""
    from repro_torch.core.environments import DEFAULT_KEY_SEED, trivial_env
    nrow, ncol = len(bra_rows), len(bra_rows[0])
    t0 = bra_rows[0][0]
    layout, devices = option.resolve(ncol, t0.device)
    keys = key_or_default(key, DEFAULT_KEY_SEED).split(max(nrow, 2))
    bra = put_columns(bra_rows, layout, devices)
    ket = bra if ket_rows is bra_rows else put_columns(ket_rows, layout, devices)
    svec = _trivial_boundary(layout, devices, t0.dtype)
    _, levels = _sweep_rows(svec, (bra, ket), option, layout, devices,
                            keys[:nrow], "twolayer", collect=True)
    return [trivial_env(ncol, t0.dtype, devices[0])] + levels


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def halo_bytes_per_row(state_or_rows, option: DistributedBMPS) -> int:
    """Bytes crossing shard boundaries per two-layer row absorption: the
    forward carry and the backward boundary tensor at every block edge
    whose two sides are on different shards, at steady-state bonds
    (boundary chi, pair bonds the interior bond squared).  Shards that
    share a device move none of them; this counts shards, not devices."""
    rows = getattr(state_or_rows, "sites", state_or_rows)
    ncol = len(rows[0])
    t = rows[min(1, len(rows) - 1)][min(1, ncol - 1)]
    layout, _ = option.resolve(ncol, t.device)
    r = max(t.shape[1:])                       # interior bond
    chi = option.chi
    carry = chi * r * r * chi * r * r          # (m, h1, h2, g, k1, k2)
    backward = chi * r * r * chi               # (l, d_bra, d_ket, r)
    blocks = layout.blocks
    edges = sum(1 for i in range(1, len(blocks))
                if blocks[i][0] != blocks[i - 1][0])
    return edges * (carry + backward) * t.element_size()
