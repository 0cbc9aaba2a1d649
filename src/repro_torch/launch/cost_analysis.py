"""What one run of a callable costs on this rank: flops, bytes accessed,
collective bytes and op counts per kind, and memory.

Counterpart of two things the reference reads from a compiled program:
``repro.launch.hlo_analysis.collective_bytes`` (the collectives of the
post-SPMD HLO, each op's output size counted once) and XLA's
``compiled.cost_analysis()`` / ``memory_analysis()`` (flops, bytes
accessed, argument and temporary bytes).  The port has no ahead-of-time
program and no HLO text, so the reference's text parser
(``_shape_bytes``, ``_OP_RE``, ``reshape_transpose_count``) has nothing
to read and is not carried over: :func:`run` executes the callable once
under a ``TorchDispatchMode`` and counts the ops that reach it.

On a ``DeviceMesh`` the mode lets ``DTensor`` desugar each op first
(it returns ``NotImplemented`` for ``DTensor`` operands, as
``CommDebugMode`` does), so it sees what this rank runs: the ops on its
local shards and the functional collectives (``torch.ops._c10d_functional``)
that ``DTensor``'s redistributes call, plus the ``c10d`` ops of plain
``torch.distributed`` calls.  Run under ``FakeTensorMode`` on a fake
process group (:func:`repro_torch.launch.mesh.make_production_mesh`) it
counts a rank of a 256- or 512-rank world without a card.

Conventions (each differs from XLA's by design; none is scaled to match):

* **collectives** — the reference's five kinds; each op's output bytes
  once.  An op of a collective namespace that is not one of the five (nor
  ``wait_tensor``, the completion of an async op, as the HLO's ``-done``)
  raises :class:`UnknownCollective`: nothing is dropped.  On a ``cpu``
  mesh ``DTensor`` runs its Shard-to-Shard all-to-all as an all-gather
  plus a chunk (gloo has no all-to-all); that fallback is counted as the
  all-to-all it stands for, output bytes the input's, and nothing inside
  it is counted, so a ``cpu`` mesh counts what a ``cuda`` one does.
* **flops** — ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``:
  matmuls, convolutions, attention); elementwise flops are not counted, as
  XLA's are.
* **bytes accessed** — the sum over aten ops of their tensor inputs' and
  outputs' bytes, views excluded (they move nothing).  Eager ops are
  unfused, so this is an upper bound of XLA's fused count.
* **DTensor's own bookkeeping** is not the program's work and runs
  uncounted: the ops on global-shape stand-ins by which its sharding
  propagation finds an op's output metadata (the first time it meets an
  op signature), and the small tensor ops that place a strided shard
  (``_StridedShard``'s local sizes and offsets; these also run outside
  ``FakeTensorMode``, where their ``.tolist()`` has no value to read).
* **memory** — ``arg_bytes`` is exact from the placements (each rank's
  local shards of the arguments); ``temp_bytes`` is the peak, over the
  run, of the bytes of storages that ops allocated and that are still
  alive (outputs included: the step does not donate its inputs).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# operator name (namespace::name) -> kind
_KIND_OF = {}
for _kind, _names in {
    "all-gather": (
        "_c10d_functional::all_gather_into_tensor",
        "_c10d_functional::all_gather_into_tensor_out",
        "_c10d_functional::all_gather_into_tensor_coalesced",
        "_c10d_functional_autograd::all_gather_into_tensor",
        "c10d_functional::all_gather_into_tensor",
        "c10d_functional::all_gather_into_tensor_coalesced",
        "c10d::allgather_", "c10d::_allgather_base_",
        "c10d::allgather_coalesced_",
        "c10d::allgather_into_tensor_coalesced_"),
    "all-reduce": (
        "_c10d_functional::all_reduce", "_c10d_functional::all_reduce_",
        "_c10d_functional::all_reduce_coalesced",
        "_c10d_functional::all_reduce_coalesced_",
        "c10d_functional::all_reduce", "c10d_functional::all_reduce_coalesced",
        "c10d::allreduce_", "c10d::allreduce_coalesced_"),
    "reduce-scatter": (
        "_c10d_functional::reduce_scatter_tensor",
        "_c10d_functional::reduce_scatter_tensor_out",
        "_c10d_functional::reduce_scatter_tensor_coalesced",
        "_c10d_functional_autograd::reduce_scatter_tensor",
        "c10d_functional::reduce_scatter_tensor",
        "c10d_functional::reduce_scatter_tensor_coalesced",
        "c10d::reduce_scatter_", "c10d::_reduce_scatter_base_",
        "c10d::reduce_scatter_tensor_coalesced_"),
    "all-to-all": (
        "_c10d_functional::all_to_all_single",
        "_c10d_functional_autograd::all_to_all_single",
        "c10d_functional::all_to_all_single",
        "c10d::alltoall_", "c10d::alltoall_base_",
        "_dtensor::shard_dim_alltoall"),
    "collective-permute": ("c10d::send", "c10d::recv_",
                           "c10d::recv_any_source_"),
}.items():
    for _name in _names:
        _KIND_OF[_name] = _kind

# namespaces whose every op is a collective or its bookkeeping
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d_functional", "c10d", "_dtensor")
# ops of those namespaces that move no data (completion, autograd wrappers)
_NOT_COLLECTIVES = frozenset((
    "_c10d_functional::wait_tensor", "c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd",
    "_c10d_functional::_unwrap_tensor_autograd",
    "c10d::barrier", "c10d::monitored_barrier_",
    "_dtensor::mesh_get_process_group"))

# metadata queries: no data moves (prim.device reaches a dispatch mode
# only under FakeTensorMode)
_SIZE_QUERIES = frozenset(
    [getattr(torch.ops.aten, name).default for name in (
        "size", "sym_size", "stride", "sym_stride", "storage_offset",
        "sym_storage_offset", "numel", "sym_numel", "dim", "is_contiguous")
     if hasattr(torch.ops.aten, name)]
    + [torch.ops.prim.device.default, torch.ops.prim.layout.default])


class UnknownCollective(RuntimeError):
    """An op of a collective namespace that is none of :data:`KINDS`."""


@dataclasses.dataclass
class Cost:
    """What :func:`run` counted on this rank."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    arg_bytes: float = 0.0
    temp_bytes: float = 0.0

    def collectives(self) -> Tuple[int, Dict[str, int], Dict[str, int]]:
        """(total bytes, bytes per kind, ops per kind): the reference's
        ``collective_bytes`` triple."""
        return (sum(self.collective_bytes.values()),
                dict(self.collective_bytes), dict(self.collective_counts))


def op_name(func) -> str:
    """``namespace::name`` of an op overload."""
    return func._schema.name


def collective_kind(func):
    """The kind of a collective op (one of :data:`KINDS`), None for any
    other op; an op of a collective namespace that is none of them raises
    :class:`UnknownCollective`."""
    name = op_name(func)
    kind = _KIND_OF.get(name)
    if kind is not None or name in _NOT_COLLECTIVES:
        return kind
    if name.split("::")[0] in _COLLECTIVE_NAMESPACES:
        raise UnknownCollective(f"{name} is a collective of none of the "
                                f"kinds {KINDS}")
    return None


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (nested dicts, lists) on this
    rank: a ``DTensor``'s local shard, a plain tensor whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 0


_state = threading.local()


class CostCounter(TorchDispatchMode):
    """The counting mode; :func:`run` is the way to use it."""

    def __init__(self):
        super().__init__()
        self.cost = Cost(collective_bytes={k: 0 for k in KINDS},
                         collective_counts={k: 0 for k in KINDS})
        self._live: Dict[int, int] = {}
        self._now = 0
        self._peak = 0
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry

    # -- memory -----------------------------------------------------------
    def _release(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as allocated until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._now += n
        self._peak = max(self._peak, self._now)
        weakref.finalize(st, self._release, key)

    def _allocated(self, func, out) -> None:
        returns = func._schema.returns
        for i, t in enumerate(_tensors(out)):
            if i >= len(returns) or returns[i].alias_info is None:
                self.track(t)

    def record_collective(self, kind: str, nbytes: int) -> None:
        self.cost.collective_bytes[kind] += int(nbytes)
        self.cost.collective_counts[kind] += 1

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor desugar to local ops
        if getattr(_state, "quiet", 0) or func in _SIZE_QUERIES:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self._flops:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        kind = collective_kind(func)
        out = func(*args, **kwargs)
        if kind is not None:
            self.record_collective(kind, sum(_nbytes(t)
                                             for t in _tensors(out)))
            self._allocated(func, out)
            return out
        if op_name(func).split("::")[0] in _COLLECTIVE_NAMESPACES:
            return out
        if packet in self._flops:
            self.cost.flops += self._flops[packet](*args, **kwargs,
                                                   out_val=out)
        if not func.is_view:
            self.cost.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs)) + _tensors(out))
        self._allocated(func, out)
        return out

    def finish(self) -> Cost:
        self.cost.temp_bytes = float(self._peak)
        self.cost.flops = float(self.cost.flops)
        return self.cost


@contextlib.contextmanager
def _quiet():
    _state.quiet = getattr(_state, "quiet", 0) + 1
    try:
        yield
    finally:
        _state.quiet -= 1


@contextlib.contextmanager
def _patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(owner.name)`` for the duration;
    nothing if ``owner`` has no such attribute (another torch release)."""
    original = getattr(owner, name, None)
    if original is None:
        yield
        return
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _uncounted(original, real=False):
    def call(*args, **kwargs):
        if not real:
            with _quiet():
                return original(*args, **kwargs)
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with _quiet(), unset_fake_temporarily():
            return original(*args, **kwargs)
    return call


def _alltoall_as_one(original):
    """On a ``cpu`` mesh, ``DTensor``'s all-to-all fallback (all-gather
    then chunk) counted as one all-to-all of its output's bytes, nothing
    inside it counted."""
    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        mode = getattr(_state, "counter", None)
        if mesh.device_type != "cpu" or mode is None:
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        with _quiet():
            out = original(input, gather_dim, shard_dim, mesh, mesh_dim)
        mode.record_collective("all-to-all", _nbytes(out))
        mode.track(out)
        return out
    return counted


@contextlib.contextmanager
def _patches():
    """DTensor's bookkeeping uncounted and the ``cpu`` all-to-all counted
    as one (see the module docstring)."""
    from torch.distributed.tensor import _sharding_prop as sp
    from torch.distributed.tensor import placement_types as pt
    with contextlib.ExitStack() as stack:
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            stack.enter_context(_patched(sp.ShardingPropagator, name,
                                         _uncounted))
        strided = getattr(pt, "_StridedShard", None)
        if strided is not None:
            stack.enter_context(_patched(
                strided, "local_shard_size_and_offset",
                lambda f: _uncounted(f, real=True)))
        stack.enter_context(_patched(pt, "shard_dim_alltoall",
                                     _alltoall_as_one))
        yield


def run(fn: Callable, *args, **kwargs) -> Tuple[Any, Cost]:
    """``fn(*args, **kwargs)`` once under the counters: (its result, the
    :class:`Cost` of the run on this rank, ``arg_bytes`` the local bytes
    of ``args`` and ``kwargs``)."""
    mode = CostCounter()
    previous = getattr(_state, "counter", None)
    _state.counter = mode
    try:
        with _patches(), mode:
            out = fn(*args, **kwargs)
    finally:
        _state.counter = previous
    cost = mode.finish()
    cost.arg_bytes = float(local_bytes((args, kwargs)))
    return out, cost
