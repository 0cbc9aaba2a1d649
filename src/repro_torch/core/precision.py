"""Precision policy: the per-precision error budget.

Counterpart of ``repro.core.precision``.

* ``precision="exact"`` (default) — the identity policy: the svd option is
  passed through unwrapped, kernels multiply in the operand dtype.
* ``precision="mixed"`` — around every einsumsvd solve the operand tensors
  are scaled to unit max-abs and demoted one storage tier (f64 -> f32,
  c128 -> c64; f32/bf16/c64 are fixed points), the solve runs in the
  demoted dtype, and the factors are promoted back with the scales folded
  into ``s``.  While the solve runs, the kernel sites multiply in bf16
  (:func:`repro_torch.kernels.dispatch.set_kernel_compute`) with f32
  accumulation: on the card that is the ``gram_complex`` and
  ``tall_apply_complex`` bf16 instantiations.  Off-kernel math runs in the
  demoted storage dtype, so a dense run measures the storage-demotion
  error alone, except that the library's options (``DirectSVD``,
  ``RandomizedSVD``) take their SVD of a single-precision matrix on the
  card in double precision (``wide_svd``): cuSOLVER's single-precision
  Jacobi SVD misses the two-layer budget.

:data:`ERROR_BUDGETS` holds the budgets, equal to the reference's table.
``BMPS(..., precision=...)`` wraps its ``svd`` option in
:class:`PrecisionWrapped` at construction, so every path that forwards
``option.svd`` inherits the policy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """How much numerical precision a contraction may give up.

    ``demote`` — demote operand storage one tier around each einsumsvd
    solve; results are promoted back.  ``kernel_compute`` — multiplicand
    dtype inside the kernel sites while a solve under this policy runs
    (accumulation is always f32); ``None`` keeps the operand dtype."""
    name: str
    demote: bool = False
    kernel_compute: Optional[str] = None

    def __str__(self):
        return self.name


EXACT = PrecisionPolicy("exact")
MIXED = PrecisionPolicy("mixed", demote=True, kernel_compute="bfloat16")

_POLICIES = {"exact": EXACT, "mixed": MIXED}


def resolve_precision(precision) -> PrecisionPolicy:
    """Accept a policy name or instance; TypeError names the choices."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    if isinstance(precision, str) and precision in _POLICIES:
        return _POLICIES[precision]
    raise TypeError(
        f"unknown precision {precision!r}: expected one of "
        f"{sorted(_POLICIES)} or a PrecisionPolicy instance")


# ---------------------------------------------------------------------------
# Dtype demotion/promotion
# ---------------------------------------------------------------------------

_DEMOTE = {torch.float64: torch.float32, torch.complex128: torch.complex64}


def demote_dtype(dtype: torch.dtype, policy: PrecisionPolicy) -> torch.dtype:
    if not policy.demote:
        return dtype
    return _DEMOTE.get(dtype, dtype)


def demote(x: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    target = demote_dtype(x.dtype, policy)
    return x if x.dtype == target else x.to(target)


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real scalar dtype matching ``dtype`` (c128 -> f64, c64 -> f32)."""
    return dtype.to_real() if dtype.is_complex else dtype


# ---------------------------------------------------------------------------
# The svd-option wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionWrapped:
    """An einsumsvd option wrapped with a precision policy.

    Callable with the option protocol ``(op, rank, key) -> (u, s, v)``:
    scales and demotes the implicit operator's tensors per the policy,
    points the kernel sites at the policy's compute dtype for the solve
    (restored in ``finally``; the dispatch state keys the planner's fused
    cache, so exact and mixed solves never share an entry), and promotes
    the factors back to the operand dtype.  The exact policy never builds
    this wrapper: :func:`wrap_svd` returns the inner option."""
    inner: object
    policy: PrecisionPolicy

    def __call__(self, op, rank: int, key=None):
        from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
        from repro_torch.core.rsvd import ImplicitOperator
        from repro_torch.kernels import dispatch
        pol = self.policy
        orig_dtype = op.dtype
        tensors = list(op.tensors)
        scale = None
        if pol.demote:
            # Per-solve operand scaling: every tensor to unit max-abs
            # before demotion, the product of the scales folded back into
            # s.  Without it an unnormalized network pushes the demoted
            # spectrum under the f32 Gram-QR eigenvalue clamp and the solve
            # collapses to zero.  The scales stay on the device.
            scales = []
            for t in tensors:
                c = t.abs().max()
                scales.append(torch.where(torch.isfinite(c) & (c > 0), c,
                                          torch.ones_like(c)))
            tensors = [t / c for t, c in zip(tensors, scales)]
            scale = scales[0]
            for c in scales[1:]:
                scale = scale * c
        tensors = [demote(t, pol) for t in tensors]
        changed = any(t.dtype != o.dtype for t, o in zip(tensors, op.tensors))
        if changed or scale is not None:
            op = ImplicitOperator(tensors, list(op.subscripts), op.row, op.col)
        wide = {"wide_svd": True} if pol.demote and isinstance(
            self.inner, (DirectSVD, RandomizedSVD)) else {}
        prev = dispatch.set_kernel_compute(pol.kernel_compute)
        try:
            u, s, v = self.inner(op, rank, key, **wide)
        finally:
            dispatch.set_kernel_compute(prev)
        if changed:
            u = u.to(orig_dtype)
            v = v.to(orig_dtype)
            s = s.to(real_dtype(orig_dtype))
        if scale is not None:
            s = s * scale.to(s.dtype)
        return u, s, v


def wrap_svd(svd, precision) -> object:
    """Apply a precision policy to an einsumsvd option.

    Idempotent: an already-wrapped option is unwrapped first.  The exact
    policy returns the bare option, so ``BMPS(chi)`` builds the same option
    with or without this module."""
    policy = resolve_precision(precision)
    if isinstance(svd, PrecisionWrapped):
        svd = svd.inner
    if not policy.demote and policy.kernel_compute is None:
        return svd
    return PrecisionWrapped(svd, policy)


def policy_of(svd) -> PrecisionPolicy:
    """The policy an (optionally wrapped) svd option carries."""
    if isinstance(svd, PrecisionWrapped):
        return svd.policy
    return EXACT


# ---------------------------------------------------------------------------
# The error-budget table (the reference's, value for value)
# ---------------------------------------------------------------------------

#: Per-(workload, precision) relative-error budgets.  ``exact`` budgets are
#: against the pinned goldens / dense references; ``mixed`` budgets against
#: the exact-path result of the identical contraction (same chi, engine,
#: key), so they isolate the precision policy from the truncation error.
ERROR_BUDGETS: Dict[str, Dict[str, object]] = {
    "contract_onelayer": {
        "case": "4x4 random one-layer D=3 grid, chi=8 zip-up",
        "exact": 1e-12,
        "mixed": 1e-4,
    },
    "contract_twolayer": {
        "case": "4x4 TFI D=3 ITE state, norm via chi=8 two-layer zip-up",
        "exact": 1e-12,
        "mixed": 1e-5,
    },
    "amplitude": {
        "case": "3x3 RQC (8 layers), one amplitude vs exact statevector",
        "exact": 1e-12,
        "mixed": 2e-5,
    },
    "full_update_ite_step": {
        "case": "one full-update ITE step on the 4x4 TFI D=3 state (energy)",
        "exact": 1e-12,
        "mixed": 5e-6,
    },
    "kernel_bf16_gemm": {
        "case": "forced-Pallas bf16-multiplicand gram/tall-apply vs f32 dense",
        "exact": 1e-12,
        "mixed": 2e-2,
    },
}


def error_budget(workload: str, precision) -> float:
    """The documented budget for ``workload`` under ``precision``."""
    policy = resolve_precision(precision)
    try:
        return float(ERROR_BUDGETS[workload][policy.name])
    except KeyError:
        raise KeyError(
            f"no budget for workload {workload!r} / precision "
            f"{policy.name!r}: known workloads {sorted(ERROR_BUDGETS)}")


def budget_table_markdown() -> str:
    """The budget table as GitHub markdown (the reference's rendering)."""
    lines = [
        "| workload | acceptance case | exact | mixed |",
        "|---|---|---|---|",
    ]
    for name, row in ERROR_BUDGETS.items():
        lines.append(f"| `{name}` | {row['case']} | {row['exact']:.0e} "
                     f"| {row['mixed']:.0e} |")
    return "\n".join(lines)
