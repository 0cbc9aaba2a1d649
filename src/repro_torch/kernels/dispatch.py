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
and ``dense_<site>_grad_calls`` (the differentiated calls of rule 3).
:func:`backend_signature` captures the state that changes what a cached
callable computes (modes, per-site overrides, compute dtype, device type);
the planner folds it into its fused-cache keys.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch

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


def grad_route(name: str, forced: bool, *args, **kwargs) -> bool:
    """Rule 3 for a call of ``name`` that would reach a kernel: True when
    autograd would record it, so that it must run dense (ticking
    ``dense_<name>_grad_calls``); raises when the kernel is ``forced``."""
    if not torch.is_grad_enabled() or not any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in (*args, *kwargs.values())):
        return False
    if forced:
        raise RuntimeError(
            f"{name}: an operand requires grad, and the port's kernels have "
            f"no backward; set the kernel backend to 'auto' or 'dense' for a "
            f"differentiated call")
    counter = f"dense_{name}_grad_calls"
    _COUNTERS[counter] = _COUNTERS.get(counter, 0) + 1
    return True


def dispatch(name: str, *args, **kwargs):
    """Run site ``name`` on ``args``, kernel- or dense-routed.  Unknown
    sites raise KeyError."""
    site = _SITES[name]
    mode = _SITE_MODES.get(name, _STATE["mode"])
    use_kernel = False
    if mode != "dense" and site.supported(*args, **kwargs):
        if grad_route(name, mode == "kernel", *args, **kwargs):
            return site.dense_fn(*args, **kwargs)
        use_kernel = mode == "kernel" or site.auto(*args, **kwargs)
    if use_kernel:
        _COUNTERS[f"kernel_{name}_calls"] += 1
        return site.kernel_fn(*args, **kwargs)
    _COUNTERS[f"dense_{name}_calls"] += 1
    return site.dense_fn(*args, **kwargs)


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
    """Effective mode, global or for one site."""
    if site is not None:
        return _SITE_MODES.get(site, _STATE["mode"])
    return _STATE["mode"]


@contextlib.contextmanager
def forced_dense():
    """Force every site dense for the duration; restores the global mode
    and the per-site overrides afterwards."""
    prev_mode = _STATE["mode"]
    prev_sites = dict(_SITE_MODES)
    _STATE["mode"] = "dense"
    _SITE_MODES.clear()
    try:
        yield
    finally:
        _STATE["mode"] = prev_mode
        _SITE_MODES.clear()
        _SITE_MODES.update(prev_sites)


def set_kernel_compute(dtype) -> Optional[str]:
    """Set the kernel multiplicand dtype (``'bfloat16'`` or
    ``torch.bfloat16``; ``None`` for the operand dtype).  Accumulation is
    always f32.  Returns the previous value."""
    prev = _STATE["compute"]
    if dtype is None:
        _STATE["compute"] = None
    else:
        name = str(dtype).replace("torch.", "")
        if name != "bfloat16":
            raise ValueError(f"unsupported kernel compute dtype {dtype!r}: "
                             "expected 'bfloat16' or None")
        _STATE["compute"] = name
    return prev


def kernel_compute() -> Optional[str]:
    return _STATE["compute"]


def backend_signature() -> tuple:
    """Every piece of dispatch state that changes what a cached callable
    computes, plus the device type kernels would launch on."""
    return (_STATE["mode"],
            tuple(sorted(_SITE_MODES.items())),
            _STATE["compute"],
            "cuda" if torch.cuda.is_available() else "cpu")


def dispatch_stats() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset_dispatch_stats() -> None:
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
