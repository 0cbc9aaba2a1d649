"""Kernel-dispatch registry: one gate for every hand-written kernel site.

Counterpart of ``repro.kernels.dispatch``.  A **site** is a named operation
with two interchangeable implementations:

* ``dense``  — the plain torch contraction (exact; the only path for
  f64/c128);
* ``kernel`` — the matricized form that runs on the hand-written CUDA
  kernels (f32 accumulation, optional bf16 multiplicands).  On a CPU tensor
  the kernel wrappers use their plain versions, so the kernel form is
  testable without a card.

Per call, :func:`dispatch` picks an implementation:

1. the site's **supported** predicate is a *hard* gate — dtypes the
   f32-accumulating kernels cannot serve at full precision (f64/c128)
   never route to a kernel, even when forced;
2. the mode — per-site override, else the global mode — decides the rest:
   ``"dense"`` forces dense, ``"kernel"`` forces the kernel, ``"auto"``
   additionally consults the site's **auto** predicate: the reference's
   tall-skinny shape gate with "a TPU backend" replaced by "the operand is
   on CUDA".  The thresholds are the reference's and were never measured
   on the H100.

3. the kernels have no backward (neither have the reference's Pallas
   kernels): a call that would reach a kernel while
   ``torch.is_grad_enabled()`` and an operand ``requires_grad`` runs dense
   under ``"auto"``, before the auto predicate is consulted, and raises a
   ``RuntimeError`` naming the site under a forced ``"kernel"``.  The
   check comes before the kernel wrapper, whose plain version on a CPU
   tensor would keep the graph, so the CPU shows what the card does.

Every decision ticks one of ``kernel_<site>_calls``, ``dense_<site>_calls``
and ``dense_<site>_grad_calls`` (the differentiated calls of rule 3).  A
call routed to the kernel first consults the fault site ``kernel.<site>``
(:mod:`repro_torch.core.faults`): armed, it raises ``InjectedFault`` before
the kernel runs and before the counter ticks, on a CPU tensor too.
:func:`backend_signature` captures the state that changes what a cached
callable computes (modes, per-site overrides, compute dtype, device type);
the planner folds it into its fused-cache keys.

The modes and the compute dtype are process-wide; :func:`forced_dense`
(the runtime guard's dense rung) and :func:`kernel_compute_scope` (the
precision policies' solves) change them for the calling thread alone, so
the worker threads of :mod:`repro_torch.core.spmd` do not see each other's
scoped changes.  Counters tick under :data:`repro_torch.counting.LOCK`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional

import torch

from repro_torch import counting

_MODES = ("auto", "kernel", "dense")

# dtypes the f32-accumulating kernels serve at full (or better) precision.
# f64/c128 are excluded unconditionally: an f32 accumulator would silently
# halve their precision.
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.complex64)


@dataclasses.dataclass(frozen=True)
class KernelSite:
    """One dispatchable operation (see module docstring)."""
    name: str
    kernel_fn: Callable
    dense_fn: Callable
    supported: Callable[..., bool]   # hard gate (dtype) — applies always
    auto: Callable[..., bool]        # soft gate (shape/device) — auto mode


_SITES: Dict[str, KernelSite] = {}
_COUNTERS: Dict[str, int] = {}
_STATE = {"mode": "auto", "compute": None}
_SITE_MODES: Dict[str, str] = {}   # per-site overrides
# the calling thread's scoped changes: ``dense`` (forced_dense) and
# ``compute`` (kernel_compute_scope; absent when no scope is open)
_LOCAL = threading.local()


def register_kernel(name: str, *, kernel: Callable, dense: Callable,
                    supported: Callable[..., bool] = None,
                    auto: Callable[..., bool] = None) -> KernelSite:
    """Register (or replace) a dispatch site.  Idempotent per name."""
    site = KernelSite(name, kernel, dense,
                      supported if supported is not None else lambda *a, **k: True,
                      auto if auto is not None else lambda *a, **k: False)
    _SITES[name] = site
    _COUNTERS.setdefault(f"kernel_{name}_calls", 0)
    _COUNTERS.setdefault(f"dense_{name}_calls", 0)
    _COUNTERS.setdefault(f"dense_{name}_grad_calls", 0)
    return site


def registered_sites() -> tuple:
    return tuple(sorted(_SITES))


def site(name: str) -> KernelSite:
    """The registered site ``name``.  Unknown sites raise KeyError."""
    return _SITES[name]


def _recorded(args, kwargs) -> bool:
    """True when autograd would record a call on these arguments."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for x in (*args, *kwargs.values()))


def grad_route(name: str, forced: bool, *args, **kwargs) -> bool:
    """Rule 3 for a call of ``name`` that would reach a kernel: True when
    autograd would record it, so that it must run dense (ticking
    ``dense_<name>_grad_calls``); raises when the kernel is ``forced``."""
    if not _recorded(args, kwargs):
        return False
    if forced:
        raise RuntimeError(
            f"{name}: an operand requires grad, and the port's kernels have "
            f"no backward; set the kernel backend to 'auto' or 'dense' for a "
            f"differentiated call")
    counting.tick(_COUNTERS, f"dense_{name}_grad_calls")
    return True


def _mode(name: Optional[str] = None) -> str:
    """The effective mode of site ``name`` (or the global one) in the
    calling thread."""
    if getattr(_LOCAL, "dense", False):
        return "dense"
    if name is not None:
        return _SITE_MODES.get(name, _STATE["mode"])
    return _STATE["mode"]


def dispatch(name: str, *args, **kwargs):
    """Run site ``name`` on ``args``, kernel- or dense-routed.  Unknown
    sites raise KeyError."""
    site = _SITES[name]
    mode = _mode(name)
    use_kernel = False
    if mode != "dense" and site.supported(*args, **kwargs):
        if grad_route(name, mode == "kernel", *args, **kwargs):
            return site.dense_fn(*args, **kwargs)
        use_kernel = mode == "kernel" or site.auto(*args, **kwargs)
    if use_kernel:
        # fault injection (the runtime guard's dense rung): an armed
        # ``kernel.<name>`` raises here, before the kernel and its count
        from repro_torch.core import faults
        if faults.should_fire(f"kernel.{name}") is not None:
            raise faults.InjectedFault(f"kernel.{name}")
        counting.tick(_COUNTERS, f"kernel_{name}_calls")
        return site.kernel_fn(*args, **kwargs)
    counting.tick(_COUNTERS, f"dense_{name}_calls")
    return site.dense_fn(*args, **kwargs)


def routes_to_kernel(name: str, *args, **kwargs) -> bool:
    """Whether :func:`dispatch` would run site ``name``'s kernel on these
    arguments (a forced kernel that would raise for a differentiated call
    counts as not), without counting, consulting faults or raising."""
    site = _SITES[name]
    mode = _mode(name)
    if (mode == "dense" or not site.supported(*args, **kwargs)
            or _recorded(args, kwargs)):
        return False
    return mode == "kernel" or site.auto(*args, **kwargs)


def set_kernel_backend(mode: str, site: Optional[str] = None) -> str:
    """Select ``'auto'`` | ``'kernel'`` | ``'dense'``, globally or for one
    ``site``.  Returns the previous value (for restore-in-finally)."""
    if mode not in _MODES:
        raise ValueError(f"bad kernel backend {mode!r}: expected one of {_MODES}")
    if site is not None:
        if site not in _SITES:
            raise KeyError(f"unknown kernel site {site!r}: "
                           f"registered: {registered_sites()}")
        prev = _SITE_MODES.get(site, _STATE["mode"])
        _SITE_MODES[site] = mode
        return prev
    prev = _STATE["mode"]
    _STATE["mode"] = mode
    _SITE_MODES.clear()    # a global set supersedes per-site overrides
    return prev


def kernel_backend(site: Optional[str] = None) -> str:
    """Effective mode in the calling thread, global or for one site."""
    return _mode(site)


@contextlib.contextmanager
def forced_dense():
    """Force every site dense in the calling thread for the duration;
    the process-wide mode and per-site overrides stay as they are."""
    prev = getattr(_LOCAL, "dense", False)
    _LOCAL.dense = True
    try:
        yield
    finally:
        _LOCAL.dense = prev


def _compute_name(dtype) -> Optional[str]:
    """``'bfloat16'`` or None for a kernel multiplicand dtype; raises on
    any other."""
    if dtype is None:
        return None
    name = str(dtype).replace("torch.", "")
    if name != "bfloat16":
        raise ValueError(f"unsupported kernel compute dtype {dtype!r}: "
                         "expected 'bfloat16' or None")
    return name


def set_kernel_compute(dtype) -> Optional[str]:
    """Set the kernel multiplicand dtype (``'bfloat16'`` or
    ``torch.bfloat16``; ``None`` for the operand dtype).  Accumulation is
    always f32.  Returns the previous value."""
    prev = _STATE["compute"]
    _STATE["compute"] = _compute_name(dtype)
    return prev


_NO_SCOPE = object()


@contextlib.contextmanager
def kernel_compute_scope(dtype):
    """The kernel multiplicand dtype ``dtype`` (as for
    :func:`set_kernel_compute`, ``None`` for the operand dtype) in the
    calling thread for the duration."""
    name = _compute_name(dtype)
    prev = getattr(_LOCAL, "compute", _NO_SCOPE)
    _LOCAL.compute = name
    try:
        yield
    finally:
        if prev is _NO_SCOPE:
            del _LOCAL.compute
        else:
            _LOCAL.compute = prev


def kernel_compute() -> Optional[str]:
    """The kernel multiplicand dtype in the calling thread."""
    scoped = getattr(_LOCAL, "compute", _NO_SCOPE)
    return _STATE["compute"] if scoped is _NO_SCOPE else scoped


def backend_signature() -> tuple:
    """Every piece of dispatch state that changes what a cached callable
    computes, plus the device type kernels would launch on."""
    dense = getattr(_LOCAL, "dense", False)
    return (_mode(),
            () if dense else tuple(sorted(_SITE_MODES.items())),
            kernel_compute(),
            "cuda" if torch.cuda.is_available() else "cpu")


def dispatch_stats() -> Dict[str, int]:
    with counting.LOCK:
        return dict(_COUNTERS)


def reset_dispatch_stats() -> None:
    with counting.LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


# ---------------------------------------------------------------------------
# Shared gate helpers (the reference's tall-skinny criterion)
# ---------------------------------------------------------------------------

KERNEL_MIN_BIG = 4096
KERNEL_MAX_SMALL = 512


def dtype_supported(*dtypes) -> bool:
    """True iff every dtype is one the f32-accumulating kernels serve."""
    return all(d in KERNEL_DTYPES for d in dtypes)


def tall_skinny_auto(nbig: int, nsmall: int, device: torch.device) -> bool:
    """The auto-mode shape/device gate shared by the GEMM-shaped sites."""
    return (nbig >= KERNEL_MIN_BIG and nsmall <= KERNEL_MAX_SMALL
            and nbig >= 8 * nsmall and device.type == "cuda")
