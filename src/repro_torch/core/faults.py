"""Deterministic fault injection for the runtime guard's degradation paths.

Counterpart of ``repro.core.faults`` (the port keeps its own copy).  Every
recovery path of :mod:`repro_torch.core.runtime_guard` — rsvd -> exact SVD,
mixed -> exact precision, kernel -> dense, torn checkpoint writes — exists
because some failure is possible in production but essentially impossible
to provoke on demand.  Named **sites** in the code call :func:`should_fire`
on every pass, and a test arms a site to misbehave on exactly the Nth call,
so each rung is testable with no randomness and no real hardware fault.

========================  ==================================================
site                      effect when armed
========================  ==================================================
``einsumsvd.result``      the factors of the next einsumsvd solve are
                          corrupted per ``action`` (``"nan"`` | ``"inf"`` |
                          ``"zero"``) — see
                          ``runtime_guard.guarded_solve``
``kernel.<site>``         the kernel-dispatch site (``kernel.gram``,
                          ``kernel.tall_apply``, ...) raises
                          :class:`InjectedFault` instead of running its
                          kernel form — see
                          ``repro_torch.kernels.dispatch.dispatch``
``checkpoint.write``      the next checkpoint write is torn: ``"torn"``
                          leaves a partial ``*.tmp`` and never publishes,
                          ``"torn_final"`` publishes a directory with a
                          truncated manifest — see
                          ``repro_torch.checkpoint.manager``
========================  ==================================================

Arming is per-process: :func:`arm` installs a spec, :func:`clear` removes
everything (or use the :func:`armed` context manager).  The site counter
ticks once per :func:`should_fire` call, and the spec fires for calls
``nth .. nth+times-1`` (1-based).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional


class InjectedFault(RuntimeError):
    """Raised by an instrumented site armed with a raising action; ``site``
    names it, so the runtime guard can pick a recovery rung."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at site {site!r}")
        self.site = site


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fire on calls ``nth .. nth+times-1`` (1-based)."""
    site: str
    nth: int = 1
    action: str = "nan"
    times: int = 1
    fired: int = 0      # how many times this spec has fired so far


_SPECS: Dict[str, FaultSpec] = {}
_CALLS: Dict[str, int] = {}


def arm(site: str, nth: int = 1, action: str = "nan",
        times: int = 1) -> FaultSpec:
    """Arm ``site`` to fire on its Nth call (and the ``times-1`` after it).
    Re-arming a site replaces its spec and resets its call counter."""
    if nth < 1 or times < 1:
        raise ValueError(f"nth/times must be >= 1, got nth={nth} times={times}")
    spec = FaultSpec(site=site, nth=nth, action=action, times=times)
    _SPECS[site] = spec
    _CALLS[site] = 0
    return spec


def disarm(site: str) -> None:
    _SPECS.pop(site, None)
    _CALLS.pop(site, None)


def clear() -> None:
    """Disarm every site and drop all call counters."""
    _SPECS.clear()
    _CALLS.clear()


def active() -> Dict[str, FaultSpec]:
    """The currently armed specs (a copy)."""
    return dict(_SPECS)


def should_fire(site: str) -> Optional[FaultSpec]:
    """Tick ``site``'s call counter; return its spec iff this call fires.
    An unarmed site costs one dict lookup."""
    spec = _SPECS.get(site)
    if spec is None:
        return None
    n = _CALLS.get(site, 0) + 1
    _CALLS[site] = n
    if spec.nth <= n < spec.nth + spec.times:
        spec.fired += 1
        return spec
    return None


@contextlib.contextmanager
def armed(site: str, nth: int = 1, action: str = "nan", times: int = 1):
    """Context-managed :func:`arm`: disarms the site on exit."""
    spec = arm(site, nth=nth, action=action, times=times)
    try:
        yield spec
    finally:
        disarm(site)
