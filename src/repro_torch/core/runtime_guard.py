"""Numerical health checks with graceful degradation (the runtime guard).

Counterpart of ``repro.core.runtime_guard``.  A long ITE sweep or VQE
optimization dies in a few well-known ways: a randomized SVD degenerates on
an ill-conditioned implicit operator, a mixed-precision solve underflows the
f32 Gram clamp, a kernel fails on the device, a boundary row collapses to
zero, or cuSOLVER's eigh raises on a non-finite bond environment.  This
module wraps the library's single truncation seam
(:func:`repro_torch.core.einsumsvd.einsumsvd` routes every solve through
:func:`guarded_solve`) with a **detect -> escalate -> retry** loop:

* **Detection** — after each solve the factors are checked for NaN/Inf
  (``check_finite``) and spectrum collapse (``norm_floor``), with one
  device-to-host read of one stacked tensor.  An exception from the solve
  is a failure too.  :mod:`repro_torch.core.full_update` also checks the
  ALS output and the bond fidelity against ``fidelity_floor``, and counts a
  ``torch.linalg.LinAlgError`` of a bond's positive fix or ALS as ``"nan"``.
* **Escalation ladder** — the retry replays the same solve (same operands,
  same key) one rung more conservative, cumulatively:

  1. ``exact_svd``       — RandomizedSVD -> DirectSVD;
  2. ``exact_precision`` — a mixed-policy wrapper is removed;
  3. ``dense_kernel``    — every kernel-dispatch site is forced dense
     (``repro_torch.kernels.dispatch.forced_dense``).

  A solve that raised tries ``dense_kernel`` first: the failure almost
  certainly came from a kernel.
* **Bounded retries** — ``max_retries`` caps the ladder; an exhausted ladder
  raises :class:`GuardExhaustedError` (site, cause, attempts, the events).
  The guard never lets NaN escape as a result.

Every detection and recovery ticks process-global counters (merged into
``planner.stats()``) and appends a :class:`GuardEvent` to the active
guard's :class:`GuardReport`, which ``ite_run`` / ``run_vqe`` attach to
their results.  With no guard active :func:`guarded_solve` adds one list
check and one dict lookup to a solve, and failures propagate as before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import faults

# ---------------------------------------------------------------------------
# Process-global counters (merged into planner.stats())
# ---------------------------------------------------------------------------

_COUNTERS: Dict[str, int] = {
    "guard_nan_events": 0,         # NaN/Inf detected in a solve's factors
    "guard_collapse_events": 0,    # spectrum collapsed below norm_floor
    "guard_exception_events": 0,   # the solve raised (kernel fault, ...)
    "guard_fidelity_events": 0,    # full-update fidelity below the floor
    "guard_retries": 0,            # total retry attempts
    "guard_rung_exact_svd": 0,
    "guard_rung_exact_precision": 0,
    "guard_rung_dense_kernel": 0,
    "guard_recovered": 0,          # failures that a ladder rung fixed
    "guard_degraded_accepted": 0,  # fidelity floor missed, run continued
    "guard_exhausted": 0,          # ladders that ran out -> structured raise
}


def global_counters() -> Dict[str, int]:
    """Process-global guard counters (a copy; planner.stats() merges them)."""
    return dict(_COUNTERS)


def reset_global_counters() -> None:
    for k in _COUNTERS:
        _COUNTERS[k] = 0


# ---------------------------------------------------------------------------
# Config / report structures
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """What the guard checks and how far it escalates.

    ``max_retries``     caps ladder attempts per failing unit.
    ``check_finite``    NaN/Inf detection on every guarded solve.
    ``norm_floor``      collapse threshold: largest singular value <= floor
                        is a failure (0.0 = only exact zero).
    ``fidelity_floor``  full update only: bond fidelity below this retries
                        the bond from an exact seed (0.0 = off).
    ``fidelity_strict`` raise when the floor is still missed after the
                        retry; by default record, warn and continue.
    """
    max_retries: int = 3
    check_finite: bool = True
    norm_floor: float = 0.0
    fidelity_floor: float = 0.0
    fidelity_strict: bool = False


@dataclasses.dataclass
class GuardEvent:
    """One detection or recovery, in causal order."""
    site: str       # "einsumsvd" | "full_update" | "vqe_grad"
    cause: str      # "nan" | "collapse" | "exception" | "fidelity"
    attempt: int    # 0 = initial detection, 1.. = retry attempts
    action: str     # "detected" | "retry:<rung>" | "recovered:<rung>"
                    # | "degraded_accepted" | "exhausted"
    detail: str = ""


@dataclasses.dataclass
class GuardReport:
    """The structured trail a guarded run attaches to its result."""
    events: List[GuardEvent] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def record(self, event: GuardEvent) -> None:
        self.events.append(event)

    def tick(self, counter: str) -> None:
        _COUNTERS[counter] += 1
        self.counters[counter] = self.counters.get(counter, 0) + 1

    @property
    def ok(self) -> bool:
        """No failure was left unrecovered (degraded-accepted counts as ok:
        the result is finite, only less accurate than asked)."""
        return not any(e.action == "exhausted" for e in self.events)

    def causes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            if e.attempt == 0:
                out[e.cause] = out.get(e.cause, 0) + 1
        return out


class GuardExhaustedError(RuntimeError):
    """The escalation ladder ran out without a healthy result: ``site``,
    ``cause``, ``attempts`` and the event trail ``events``."""

    def __init__(self, site: str, cause: str, attempts: int,
                 events: List[GuardEvent]):
        rungs = [e.action for e in events if e.action.startswith("retry:")]
        super().__init__(
            f"runtime guard exhausted at site {site!r}: cause={cause!r} "
            f"survived {attempts} escalation attempts ({', '.join(rungs)})")
        self.site = site
        self.cause = cause
        self.attempts = attempts
        self.events = events


# ---------------------------------------------------------------------------
# The active-guard stack
# ---------------------------------------------------------------------------

_STACK: List["RuntimeGuard"] = []


class RuntimeGuard:
    """An activated guard: config + report, installed with ``with``."""

    def __init__(self, config: Optional[GuardConfig] = None):
        self.config = config or GuardConfig()
        self.report = GuardReport()

    def __enter__(self) -> "RuntimeGuard":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.remove(self)


def current() -> Optional[RuntimeGuard]:
    """The innermost active guard, or None (the unguarded fast path)."""
    return _STACK[-1] if _STACK else None


def resolve(guard) -> Optional[RuntimeGuard]:
    """Normalize the ``guard=`` argument of ite_run/run_vqe: ``None`` or
    ``False`` -> no guard; ``True`` -> defaults; a :class:`GuardConfig` or
    :class:`RuntimeGuard` is used as it is."""
    if guard is None or guard is False:
        return None
    if guard is True:
        return RuntimeGuard(GuardConfig())
    if isinstance(guard, GuardConfig):
        return RuntimeGuard(guard)
    if isinstance(guard, RuntimeGuard):
        return guard
    raise TypeError(
        f"guard must be None/bool/GuardConfig/RuntimeGuard, got {guard!r}")


# ---------------------------------------------------------------------------
# Failure detection
# ---------------------------------------------------------------------------

def _corrupt(s: torch.Tensor, action: str) -> torch.Tensor:
    """Apply an injected einsumsvd.result corruption to the spectrum."""
    if action == "nan":
        return s * math.nan
    if action == "inf":
        return s * math.inf
    if action == "zero":
        return torch.zeros_like(s)
    raise ValueError(f"unknown einsumsvd.result fault action {action!r}")


def _nonfinite(*xs: torch.Tensor) -> torch.Tensor:
    """A device bool: does any of ``xs`` hold NaN or Inf?"""
    bad = [(~torch.isfinite(x)).any() for x in xs]
    out = bad[0]
    for b in bad[1:]:
        out = out | b
    return out


def _detect_svd(config: GuardConfig, u, s, v) -> Optional[str]:
    """One host read: NaN/Inf anywhere in the factors, or collapsed s."""
    if not config.check_finite:
        return None
    with torch.no_grad():
        smax = s.abs().max()
        flags = torch.stack([_nonfinite(u, s, v).to(torch.float32),
                             smax.to(torch.float32)]).tolist()
    if flags[0]:
        return "nan"
    if not math.isfinite(flags[1]) or flags[1] <= config.norm_floor:
        return "collapse"
    return None


# ---------------------------------------------------------------------------
# The escalation ladder
# ---------------------------------------------------------------------------

def _ladder(option, exception_first: bool) -> List[Tuple[str, object, bool]]:
    """Cumulative ``(rung_name, svd_option, force_dense)`` escalation steps:
    each rung keeps every earlier rung's downgrade."""
    from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
    from repro_torch.core.precision import PrecisionWrapped

    rungs: List[Tuple[str, object, bool]] = []
    cur = option
    base = cur.inner if isinstance(cur, PrecisionWrapped) else cur
    if isinstance(base, RandomizedSVD):
        exact = DirectSVD(cutoff=base.cutoff)
        cur = (PrecisionWrapped(exact, cur.policy)
               if isinstance(cur, PrecisionWrapped) else exact)
        rungs.append(("exact_svd", cur, False))
    if isinstance(cur, PrecisionWrapped):
        cur = cur.inner
        rungs.append(("exact_precision", cur, False))
    rungs.append(("dense_kernel", cur, True))
    if exception_first:
        # a raising solve is a kernel problem, not a numerical one: fall
        # back to dense first and keep the cheaper solver if that heals
        rungs.insert(0, ("dense_kernel", option, True))
    return rungs


def _run_solve(option, op, rank, key, force_dense: bool):
    from repro_torch.kernels import dispatch
    if force_dense:
        with dispatch.forced_dense():
            return option(op, rank, key)
    return option(op, rank, key)


def guarded_solve(option, op, rank: int, key=None):
    """Run an einsumsvd option under the active guard (the library seam).

    With no guard active this is ``option(op, rank, key)`` plus the
    ``einsumsvd.result`` fault hook, so an unguarded corruption propagates.
    With a guard: detect, escalate, retry (module docstring)."""
    guard = current()
    spec = faults.should_fire("einsumsvd.result")
    err = None
    try:
        u, s, v = _run_solve(option, op, rank, key, False)
        if spec is not None:
            s = _corrupt(s, spec.action)
        if guard is None:
            return u, s, v
        cause = _detect_svd(guard.config, u, s, v)
    except Exception as e:  # noqa: BLE001 — every solve failure is guardable
        if guard is None:
            raise
        err = e
        cause = "exception"
    if cause is None:
        return u, s, v

    config, report = guard.config, guard.report
    report.tick(f"guard_{cause}_events")
    report.record(GuardEvent("einsumsvd", cause, 0, "detected",
                             detail=repr(err) if err else ""))
    rungs = _ladder(option, exception_first=(cause == "exception"))
    attempts = 0
    for rung, opt, force_dense in rungs[:config.max_retries]:
        attempts += 1
        report.tick("guard_retries")
        report.tick(f"guard_rung_{rung}")
        report.record(GuardEvent("einsumsvd", cause, attempts,
                                 f"retry:{rung}"))
        retry_spec = faults.should_fire("einsumsvd.result")
        try:
            u, s, v = _run_solve(opt, op, rank, key, force_dense)
            if retry_spec is not None:
                s = _corrupt(s, retry_spec.action)
            recheck = _detect_svd(config, u, s, v)
        except Exception as e:  # noqa: BLE001
            err = e
            recheck = "exception"
        if recheck is None:
            report.tick("guard_recovered")
            report.record(GuardEvent("einsumsvd", cause, attempts,
                                     f"recovered:{rung}"))
            return u, s, v
        cause = recheck
    report.tick("guard_exhausted")
    report.record(GuardEvent("einsumsvd", cause, attempts, "exhausted",
                             detail=repr(err) if err else ""))
    raise GuardExhaustedError("einsumsvd", cause, attempts,
                              list(report.events))


# ---------------------------------------------------------------------------
# Full-update bond guard (called from repro_torch.core.full_update)
# ---------------------------------------------------------------------------

def check_bond(guard: RuntimeGuard, ar, br, fid) -> Optional[str]:
    """Failure cause of a full-update ALS result, or None when healthy:
    ``"nan"`` when the optimized pair is non-finite, ``"fidelity"`` when
    the bond fidelity misses the configured floor (a NaN fidelity counts).
    One host read."""
    config = guard.config
    want_fid = config.fidelity_floor > 0.0
    if not config.check_finite and not want_fid:
        return None
    with torch.no_grad():
        flags = [_nonfinite(ar, br).to(torch.float64)
                 if config.check_finite else torch.zeros((), device=ar.device,
                                                         dtype=torch.float64),
                 fid.real.to(torch.float64)]
        bad, f = torch.stack(flags).tolist()
    if bad:
        return "nan"
    if want_fid and not f >= config.fidelity_floor:   # NaN compares False
        return "fidelity"
    return None


def bond_failure(guard: RuntimeGuard, cause: str, retried: bool,
                 detail: str = "") -> None:
    """Record the outcome of a full-update bond failure.

    The first detection (``retried=False``) ticks the cause counters; after
    the retry it raises (NaN, or a fidelity miss under ``fidelity_strict``)
    or records the bond as degraded but accepted."""
    report = guard.report
    if not retried:
        report.tick(f"guard_{cause}_events")
        report.tick("guard_retries")
        report.tick("guard_rung_exact_svd")
        report.record(GuardEvent("full_update", cause, 0, "detected", detail))
        report.record(GuardEvent("full_update", cause, 1, "retry:exact_svd"))
        return
    if cause == "fidelity" and not guard.config.fidelity_strict:
        report.tick("guard_degraded_accepted")
        report.record(GuardEvent("full_update", cause, 1,
                                 "degraded_accepted", detail))
        warnings.warn(
            f"full-update bond fidelity below floor after exact retry "
            f"({detail}); continuing degraded (fidelity_strict=False)",
            RuntimeWarning)
        return
    report.tick("guard_exhausted")
    report.record(GuardEvent("full_update", cause, 1, "exhausted", detail))
    raise GuardExhaustedError("full_update", cause, 1, list(report.events))


def bond_recovered(guard: RuntimeGuard, cause: str) -> None:
    guard.report.tick("guard_recovered")
    guard.report.record(GuardEvent("full_update", cause, 1,
                                   "recovered:exact_svd"))


@contextlib.contextmanager
def suspended():
    """Temporarily deactivate the per-solve guard stack.

    A differentiated VQE evaluation is guarded at evaluation granularity
    instead (:func:`repro_torch.core.vqe.vqe_energy_and_grad`): its output
    is checked on the host and a non-finite one replays the whole
    evaluation one rung more conservative, as the reference does, where a
    per-solve host read cannot run under tracing.  The stack is restored
    on exit."""
    saved = _STACK[:]
    del _STACK[:]
    try:
        yield
    finally:
        _STACK[:] = saved


@contextlib.contextmanager
def maybe(guard: Optional[RuntimeGuard]):
    """``with maybe(resolve(guard)):`` — a no-op when guard is None."""
    if guard is None:
        yield None
    else:
        with guard:
            yield guard
