"""Device meshes of the port — counterpart of ``repro.launch.mesh``.

A :class:`Mesh` is a named grid of ``torch.device``s: the placement map
that :class:`repro_torch.core.distributed.DistributedBMPS` (column shards)
and :func:`repro_torch.core.sharding.ensemble_sharding` (ensemble members)
read.  It compiles nothing and owns no process group: each cell only says
where a shard or a member runs.

The default devices are every visible CUDA device; without a card a mesh
needs ``devices=`` (the CPU tests pass ``("cpu",)``).  Unlike a JAX mesh,
cells wrap round-robin over fewer devices than cells, so
``peps_mesh(2, 4)`` exists on one card and on the CPU: the layouts that
the reference can only exercise on distinct (or faked) devices run here
anywhere, with the same values, as blocking never changes them.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA one with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices(device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """Every visible device of ``device_type``: the CUDA cards in index
    order (raises without one), or the one CPU device."""
    if device_type == "cpu":
        return (torch.device("cpu"),)
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass devices=('cpu',) to build a "
            "mesh on the CPU")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names``, ``shape`` and ``size``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs as many "
                             f"axis names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``; cell ``k`` in
    row-major order holds ``devices[k % len(devices)]``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh shape {shape} for axes {axes}")
    devs = (visible_devices() if devices is None
            else tuple(_device(d) for d in devices))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    grid = np.empty(int(np.prod(shape)), dtype=object)
    for k in range(grid.size):
        grid[k] = devs[k % len(devs)]
    return Mesh(grid.reshape(shape), axes)


def make_host_mesh(devices=None) -> Mesh:
    """1x1 ``('data', 'model')`` mesh on the first device."""
    devs = visible_devices() if devices is None else devices
    return make_mesh((1, 1), ("data", "model"), devs[:1])


def peps_mesh(n_col_shards: int, batch: int = 1, devices=None) -> Mesh:
    """Mesh for column-sharded PEPS contraction: ``('col', 'batch')``.

    ``col`` is the column-shard axis read by
    :meth:`repro_torch.core.distributed.DistributedBMPS.for_mesh`;
    ``batch`` slices the devices across ensemble members, one column of
    the grid per member.  The same mesh places the members of
    ``run_vqe(..., ensemble=k, mesh=peps_mesh(cols, batch))``
    (:func:`repro_torch.core.sharding.ensemble_sharding`)."""
    return make_mesh((n_col_shards, batch), ("col", "batch"), devices)


def col_mesh(devices) -> Mesh:
    """1-D ``('col',)`` mesh over an explicit device list."""
    return make_mesh((len(devices),), ("col",), devices)
