"""The einsumsvd abstraction (paper Section II-C / IV-A).

Counterpart of ``repro.core.einsumsvd``: contract a tensor network into one
tensor and refactorize it into two joined by a single truncated bond.

* :class:`DirectSVD` — materialize theta, matricize, LAPACK SVD.
* :class:`RandomizedSVD` — implicit randomized SVD (Alg. 4): theta is never
  formed.

All paths truncate to a static rank; an optional relative ``cutoff`` zeroes
trailing singular values (shape-preserving).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.core import planner
from repro_torch.core.rsvd import ImplicitOperator, randomized_svd
from repro_torch.core.svd_grad import sqrt_reg, svd_reg


def _apply_cutoff(s: torch.Tensor, cutoff: float) -> torch.Tensor:
    if cutoff <= 0.0:
        return s
    return torch.where(s >= cutoff * s[0], s, torch.zeros_like(s))


@dataclasses.dataclass(frozen=True)
class DirectSVD:
    """Explicitly contract theta, then truncated LAPACK SVD."""
    cutoff: float = 0.0

    def __call__(self, op: ImplicitOperator, rank: int, key=None):
        theta = op.dense()
        m, n = op.row_size, op.col_size
        rank = min(rank, m, n)
        u, s, vh = svd_reg(theta.reshape(m, n))
        u, s, vh = u[:, :rank], s[:rank], vh[:rank]
        s = _apply_cutoff(s, self.cutoff)
        return (u.reshape(op.row_shape + (rank,)), s,
                vh.reshape((rank,) + op.col_shape))


@dataclasses.dataclass(frozen=True)
class RandomizedSVD:
    """Implicit randomized SVD (paper Alg. 4).

    ``fused`` (default) runs the solve through the planner's per-signature
    callable cache; ``fused=False`` calls :func:`randomized_svd` directly.
    Both compute the same result for the same key."""
    niter: int = 4
    oversample: int = 8
    cutoff: float = 0.0
    gram_final: bool = True
    fused: bool = True

    def __call__(self, op: ImplicitOperator, rank: int, key=None):
        if self.fused:
            u, s, v = planner.fused_randomized_svd(
                op, rank, n_iter=self.niter, oversample=self.oversample,
                key=key, gram_final=self.gram_final)
        else:
            u, s, v = randomized_svd(op, rank, self.niter, self.oversample,
                                     key, gram_final=self.gram_final)
        return u, _apply_cutoff(s, self.cutoff), v


def einsumsvd(option, tensors: Sequence[torch.Tensor],
              subscripts: Sequence[str], row: str, col: str, rank: int,
              absorb: str = "both", key=None) -> Tuple[torch.Tensor, ...]:
    """Contract the network and refactorize into (left, right) along a new
    bond: the LAST axis of ``left`` and the FIRST axis of ``right``.

    ``absorb``: 'both' (sqrt(s) into each factor), 'left', 'right', or
    'none' (returns (u, s, v))."""
    op = ImplicitOperator(tensors, subscripts, row, col)
    u, s, v = option(op, rank, key)
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
