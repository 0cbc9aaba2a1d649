"""The einsumsvd abstraction (paper Section II-C / IV-A).

Counterpart of ``repro.core.einsumsvd``: contract a tensor network into one
tensor and refactorize it into two joined by a single truncated bond.

* :class:`DirectSVD` — materialize theta, matricize, LAPACK SVD.
* :class:`RandomizedSVD` — implicit randomized SVD (Alg. 4): theta is never
  formed.

All paths truncate to a static rank; an optional relative ``cutoff`` zeroes
trailing singular values (shape-preserving).  Every solve goes through
:func:`repro_torch.core.runtime_guard.guarded_solve`, and ``precision=``
wraps the option in a precision policy (:mod:`repro_torch.core.precision`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core import planner, runtime_guard
from repro_torch.core.rsvd import ImplicitOperator, randomized_svd
from repro_torch.core.svd_grad import sqrt_reg, svd_reg


def _apply_cutoff(s: torch.Tensor, cutoff: float) -> torch.Tensor:
    if cutoff <= 0.0:
        return s
    return torch.where(s >= cutoff * s[0], s, torch.zeros_like(s))


@dataclasses.dataclass(frozen=True)
class DirectSVD:
    """Explicitly contract theta, then truncated LAPACK SVD.

    ``wide_svd`` (a call's argument, set by the mixed precision policy's
    solves): a single-precision theta on the card is factored in double
    precision (:func:`repro_torch.core.svd_grad.svd_reg`)."""
    cutoff: float = 0.0

    def __call__(self, op: ImplicitOperator, rank: int, key=None,
                 wide_svd: bool = False):
        theta = op.dense()
        m, n = op.row_size, op.col_size
        rank = min(rank, m, n)
        u, s, vh = svd_reg(theta.reshape(m, n), wide_svd)
        u, s, vh = u[:, :rank], s[:rank], vh[:rank]
        s = _apply_cutoff(s, self.cutoff)
        return (u.reshape(op.row_shape + (rank,)), s,
                vh.reshape((rank,) + op.col_shape))


@dataclasses.dataclass(frozen=True)
class RandomizedSVD:
    """Implicit randomized SVD (paper Alg. 4).

    ``fused`` (default) runs the solve through the planner's per-signature
    callable cache; ``fused=False`` calls :func:`randomized_svd` directly.
    Both compute the same result for the same key.  ``wide_svd`` as for
    :class:`DirectSVD`."""
    niter: int = 4
    oversample: int = 8
    cutoff: float = 0.0
    gram_final: bool = True
    fused: bool = True

    def __call__(self, op: ImplicitOperator, rank: int, key=None,
                 wide_svd: bool = False):
        if self.fused:
            u, s, v = planner.fused_randomized_svd(
                op, rank, n_iter=self.niter, oversample=self.oversample,
                key=key, gram_final=self.gram_final, wide_svd=wide_svd)
        else:
            u, s, v = randomized_svd(op, rank, self.niter, self.oversample,
                                     key, gram_final=self.gram_final,
                                     wide_svd=wide_svd)
        return u, _apply_cutoff(s, self.cutoff), v


def einsumsvd(option, tensors: Sequence[torch.Tensor],
              subscripts: Sequence[str], row: str, col: str, rank: int,
              absorb: str = "both", key=None,
              precision=None) -> Tuple[torch.Tensor, ...]:
    """Contract the network and refactorize into (left, right) along a new
    bond: the LAST axis of ``left`` and the FIRST axis of ``right``.

    ``absorb``: 'both' (sqrt(s) into each factor), 'left', 'right', or
    'none' (returns (u, s, v)).  ``precision``: a policy name or instance
    (``"exact"`` | ``"mixed"``, :mod:`repro_torch.core.precision`) applied
    to the option for this call; ``None`` keeps the option's own."""
    if precision is not None:
        from repro_torch.core.precision import wrap_svd
        option = wrap_svd(option, precision)
    op = ImplicitOperator(tensors, subscripts, row, col)
    # every truncation of the library passes here, so the runtime guard's
    # detect/escalate/retry loop wraps exactly this call; unguarded it is
    # option(op, rank, key)
    u, s, v = runtime_guard.guarded_solve(option, op, rank, key)
    if absorb == "none":
        return u, s, v
    return absorb_factors(u, s, v, absorb)


def absorb_factors(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor,
                   absorb: str = "both") -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the singular values into the factors (einsumsvd conventions)."""
    col = (slice(None),) + (None,) * (v.dim() - 1)
    if absorb == "both":
        sq = sqrt_reg(s)
        return u * sq, sq[col] * v
    if absorb == "left":
        return u * s, v
    if absorb == "right":
        return u, s[col] * v
    raise ValueError(f"bad absorb={absorb!r}")


def truncation_error(op_dense: torch.Tensor, u, s, v) -> torch.Tensor:
    """Frobenius-norm relative error of a refactorization (test utility)."""
    rank = s.shape[0]
    left = u.reshape(-1, rank)
    right = v.reshape(rank, -1)
    approx = (left * s) @ right
    exact = op_dense.reshape(left.shape[0], right.shape[1])
    return torch.linalg.norm(approx - exact) / torch.clamp(
        torch.linalg.norm(exact), min=1e-300)
