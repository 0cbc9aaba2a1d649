"""Device meshes of the port — counterpart of ``repro.launch.mesh``.

Two kinds of mesh live here, for two kinds of program:

* A :class:`Mesh` is a named grid of ``torch.device``s: the placement map
  that :class:`repro_torch.core.distributed.DistributedBMPS` (column
  shards) and :func:`repro_torch.core.sharding.ensemble_sharding`
  (ensemble members) read, from one process with a thread per shard.  It
  compiles nothing and owns no process group: each cell only says where a
  shard or a member runs.
* :func:`make_device_mesh` returns a ``torch.distributed`` ``DeviceMesh``
  over a process group with one process (rank) per device: the SPMD
  program of sharded LM training, where each rank runs the same step on
  its shards.  :func:`init_distributed` joins the group, and
  :func:`spawn_ranks` starts one process per rank on this host.
* :func:`make_production_mesh` (and :func:`make_fake_mesh` for any
  shape) returns a ``DeviceMesh`` of 256 or 512 ranks of a *fake* process
  group with this process as rank 0: collectives move nothing, so the
  dry-run (:mod:`repro_torch.launch.dryrun`) runs one rank's step of a
  production mesh on fake tensors.

It also holds the card's constants that the roofline
(:mod:`repro_torch.launch.roofline`) and ``chip_smoke.py``'s bounds read.

The default devices are every visible CUDA device; without a card a mesh
needs ``devices=`` (the CPU tests pass ``("cpu",)``).  Unlike a JAX mesh,
cells wrap round-robin over fewer devices than cells, so
``peps_mesh(2, 4)`` exists on one card and on the CPU: the layouts that
the reference can only exercise on distinct (or faked) devices run here
anywhere, with the same values, as blocking never changes them.
"""
from __future__ import annotations

import os
import socket
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


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


# ---------------------------------------------------------------------------
# Process-group meshes (one rank per device)
# ---------------------------------------------------------------------------

def mesh_axes(shape) -> Tuple[str, ...]:
    """The reference launcher's axis names for a mesh of ``shape``:
    ``(data, model)``, or ``(pod, data, model)`` for three axes."""
    if len(shape) == 3:
        return ("pod", "data", "model")
    if len(shape) in (1, 2):
        return ("data", "model")[:len(shape)]
    raise ValueError(f"a mesh of {len(shape)} axes has no reference names; "
                     f"expected 1 to 3 (e.g. 2x2 or 2x2x2)")


def init_distributed(device, init_method: str = None) -> torch.device:
    """Join the process group described by the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` or
    :func:`spawn_ranks` set them, or a store named by ``init_method``,
    such as ``file:///path``; ``LOCAL_RANK`` picks the card) and return
    this rank's device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU over
    gloo when ``device`` is the CPU.  A rank without a card of its own
    raises: NCCL refuses two ranks on one card."""
    device = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass the CPU "
                               "device to train on gloo")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} (local rank {local}) has no card: "
                f"{torch.cuda.device_count()} visible, one rank per card")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    if not dist.is_initialized():
        kwargs = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **kwargs)
    return device


def make_device_mesh(shape, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the joined process group, rank
    ``r`` at row-major cell ``r``, with the reference's axis names
    (:func:`mesh_axes`).  The group's size must be the mesh's: a rank per
    cell."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    axes = mesh_axes(shape)
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{int(np.prod(shape))} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


# The fake world's size: the reference's multi-pod mesh, so that every
# mesh of the dry-run and its tests is a block of one world.
FAKE_WORLD = 512


def make_fake_mesh(shape, device_type: str = None):
    """A ``DeviceMesh`` of ``shape`` (the reference's axis names,
    :func:`mesh_axes`) over ranks ``0 .. prod(shape) - 1`` of a fake
    process group, this process rank 0
    (``torch.testing._internal.distributed.fake_pg``: every collective
    returns at once and moves nothing).  The world has
    ``max(FAKE_WORLD, prod(shape))`` ranks and is joined once: every mesh
    is a block of it, so a mesh of a shape made before stays valid (a
    world replaced under ``DTensor``'s caches would leave them holding
    groups that no longer exist).

    The mesh is ``cuda`` wherever torch sees a card, so that ``DTensor``
    takes the collectives NCCL runs (its all-to-all included), else
    ``cpu`` (see :mod:`repro_torch.launch.cost_analysis` for how the
    ``cpu`` mesh's all-to-all fallback is counted).  A real (NCCL or
    gloo) group in this process raises: the fake world cannot share a
    process with it."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = tuple(int(s) for s in shape)
    cells = int(np.prod(shape))
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(
                f"a {backend} process group is already joined in this "
                f"process: a fake world cannot share a process with it "
                f"(run the dry-run in a process of its own)")
        if dist.get_world_size() < cells:
            raise RuntimeError(
                f"a {'x'.join(map(str, shape))} mesh needs {cells} ranks; "
                f"the fake world of this process has "
                f"{dist.get_world_size()}")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=max(FAKE_WORLD, cells))
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(cells).reshape(shape),
                      mesh_dim_names=mesh_axes(shape))


def make_production_mesh(multi_pod: bool = False, device_type: str = None):
    """The reference's production mesh on a fake world: (data 16, model
    16), 256 ranks, or (pod 2, data 16, model 16), 512 ranks (see
    :func:`make_fake_mesh`)."""
    return make_fake_mesh((2, 16, 16) if multi_pod else (16, 16),
                          device_type)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, threads: int,
               fn: Callable, args: tuple) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                threads: int = 0) -> None:
    """Run ``fn(*args)`` in ``world`` new processes (spawned), rank ``r``
    with ``RANK``/``LOCAL_RANK`` ``r`` and a free localhost port for the
    group's store; each calls :func:`init_distributed` itself.
    ``threads`` > 0 sets each rank's intra-op threads.  Returns when every
    rank has ended; a rank that fails or exits with a code other than 0
    raises ``torch.multiprocessing.ProcessExitedException`` (or
    ``ProcessRaisedException``) here, after the others are ended."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(world, _free_port(), threads, fn,
                                         args),
                       nprocs=world, start_method="spawn")


# ---------------------------------------------------------------------------
# The card's constants (NVIDIA H100 SXM5 80 GB), per card
# ---------------------------------------------------------------------------

# From the H100 SXM data sheet: f32 outside the tensor cores, dense bf16
# on them, and HBM3 bandwidth (chip_smoke.py's bounds read them too)
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# Bandwidth between cards for the roofline's collective term: the NCCL
# all-reduce bus bandwidth plateau (nccl-tests' convention, 256 MiB to
# 1 GiB) that chip_smoke.py's dryrun phase measured over four H100 80GB
# HBM3 cards at 700.00 W on one NVLink host (PERF.md); the data sheet's
# NVLink 4 figure is 450e9 B/s a direction.
LINK_BW = 336.9e9
