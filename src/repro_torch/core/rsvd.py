"""Randomized SVD with an implicit tensor-network operator (paper Alg. 4).

Counterpart of ``repro.core.rsvd``.  The operator ``A : C^{col} -> C^{row}``
is an *uncontracted* tensor network; ``A q`` and ``A^H p`` attach the
sketch to the network and contract it along a cached optimal path — the
dense A is never formed.  The sketch comes from a key object
(:mod:`repro_torch.core.keys`).
"""
from __future__ import annotations

import functools
import math
import string
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import planner
from repro_torch.core.keys import TorchKey
from repro_torch.core.orthogonalize import gram_qr, orthogonalize_cols, \
    tall_project
from repro_torch.core.svd_grad import svd_reg

_ALL_LABELS = string.ascii_letters


class ImplicitOperator:
    """A linear operator defined by a tensor network.

    ``tensors`` with one einsum label string each (``subscripts``); ``row``
    and ``col`` are the dangling labels of the output and input modes.
    Every other label is summed over."""

    def __init__(self, tensors: Sequence[torch.Tensor],
                 subscripts: Sequence[str], row: str, col: str):
        if len(tensors) != len(subscripts):
            raise ValueError("one subscript string per tensor")
        self.tensors = list(tensors)
        self.subscripts = list(subscripts)
        self.row = row
        self.col = col
        label_dims = {}
        for t, sub in zip(self.tensors, self.subscripts):
            if t.dim() != len(sub):
                raise ValueError(f"tensor of shape {tuple(t.shape)} vs "
                                 f"subscripts {sub!r}")
            for ax, ch in enumerate(sub):
                d = t.shape[ax]
                if ch in label_dims and label_dims[ch] != d:
                    raise ValueError(f"label {ch}: dim mismatch "
                                     f"{label_dims[ch]} vs {d}")
                label_dims[ch] = d
        self.label_dims = label_dims
        used = set("".join(self.subscripts))
        free = [c for c in _ALL_LABELS if c not in used]
        if not free:
            raise ValueError("ran out of einsum labels")
        self._sketch = free[0]
        self.dtype = functools.reduce(torch.promote_types,
                                      [t.dtype for t in self.tensors])
        self.device = self.tensors[0].device

    @property
    def row_shape(self) -> Tuple[int, ...]:
        return tuple(self.label_dims[c] for c in self.row)

    @property
    def col_shape(self) -> Tuple[int, ...]:
        return tuple(self.label_dims[c] for c in self.col)

    @property
    def row_size(self) -> int:
        return math.prod(self.row_shape)

    @property
    def col_size(self) -> int:
        return math.prod(self.col_shape)

    def _einsum(self, extra_subs: List[str], extra_tensors: List[torch.Tensor],
                out: str, conjugate: bool = False) -> torch.Tensor:
        subs = self.subscripts + extra_subs
        tensors = [t.conj() for t in self.tensors] if conjugate else self.tensors
        expr = ",".join(subs) + "->" + out
        return planner.cached_einsum(expr, *tensors, *extra_tensors)

    def dense(self) -> torch.Tensor:
        """Materialize A as a tensor of shape row_shape + col_shape."""
        return self._einsum([], [], self.row + self.col)

    def matvecs(self, q: torch.Tensor) -> torch.Tensor:
        """A @ q for a sketch q of shape col_shape + (k,)."""
        z = self._sketch
        return self._einsum([self.col + z], [q], self.row + z)

    def rmatvecs(self, p: torch.Tensor) -> torch.Tensor:
        """A^H @ p for a sketch p of shape row_shape + (k,)."""
        z = self._sketch
        return self._einsum([self.row + z], [p], self.col + z, conjugate=True)


def randomized_svd(op: ImplicitOperator, rank: int, n_iter: int = 4,
                   oversample: int = 8, key=None, gram_final: bool = True,
                   wide_svd: bool = False):
    """Alg. 4: truncated SVD of an implicit operator.

    Returns ``(u, s, v)`` with ``u``: row_shape+(rank,), ``s``: (rank,),
    ``v``: (rank,)+col_shape, such that ``A ~= u @ diag(s) @ v``.
    ``gram_final`` Gram-QRs the tall ``T = A^H P`` and SVDs only its k x k
    R factor instead of the k x Ncol matrix ``P^H A``.  ``wide_svd``: the
    small SVD of a single-precision operator on the card in double precision
    (:func:`repro_torch.core.svd_grad.svd_reg`)."""
    if key is None:
        key = TorchKey(0)
    max_rank = min(op.row_size, op.col_size)
    rank = min(rank, max_rank)
    k = min(rank + oversample, max_rank)

    q = key.sketch(op.col_shape + (k,), op.dtype, op.device).to(op.device)
    p = orthogonalize_cols(op.matvecs(q))
    for _ in range(n_iter):
        q = orthogonalize_cols(op.rmatvecs(p))
        p = orthogonalize_cols(op.matvecs(q))

    t = op.rmatvecs(p)                               # col_shape + (k,)
    if gram_final:
        q_t, r_t = gram_qr(t, 1)                     # q_t: col+(k,), r_t: (k,k)
        # A ~= P T^H = P (q_t r_t)^H = P r_t^H q_t^H
        u_small, s, vh_small = svd_reg(r_t.mH, wide_svd)
        u_small, s, vh_small = u_small[:, :rank], s[:rank], vh_small[:rank]
        u = tall_project(p, u_small, 1)              # row_shape+(rank,)
        v = tall_project(q_t.conj(), vh_small.T, 1)  # col_shape+(rank,)
        return u, s, v.movedim(-1, 0)
    b = t.conj().reshape(op.col_size, k).T           # (k, ncol)
    u_small, s, vh = svd_reg(b, wide_svd)
    u_small, s, vh = u_small[:, :rank], s[:rank], vh[:rank]
    u = tall_project(p, u_small, 1)
    return u, s, vh.reshape((rank,) + op.col_shape)
