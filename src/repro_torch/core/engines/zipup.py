"""Zip-up boundary engine (paper Alg. 3) — counterpart of
``repro.core.engines.zipup``.

One einsumsvd per column, the carry threaded left to right, truncation
interleaved with the MPO application.  The column-block kernels
(:func:`zipup_block` / :func:`zipup_block_twolayer`) keep the reference's
block/carry semantics; a whole row is one block.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.einsumsvd import einsumsvd
from repro_torch.core.engines import BoundaryEngine, register_engine
from repro_torch.core.keys import key_or_default
from repro_torch.kernels.zipup_block import (
    first_column_onelayer,
    first_column_twolayer,
    pair_merge,
)


def _keys(key, n):
    return key_or_default(key, 0).split(n)


# ---------------------------------------------------------------------------
# One-layer: PEPS without physical indices, site tensors (u, l, d, r)
# ---------------------------------------------------------------------------

def zipup_block(v: Optional[torch.Tensor], svec_block: Sequence[torch.Tensor],
                row_block: Sequence[torch.Tensor], chi: int, svd,
                keys: Sequence, first: bool, last: bool):
    """One-layer zip-up over a contiguous column block.

    Threads the carry ``v`` (axes ``(a, e, b, c)``: truncated bond,
    dangling, boundary bond, MPO bond) through the block.  ``first`` blocks
    initialize the carry from column 0 (no truncation); ``last`` blocks
    close it.  Returns ``(out, carry)`` as in the reference."""
    out: List[torch.Tensor] = []
    j0 = 0
    if first:
        # V0: S_0 (b,f,g) x O_0 (f,c,h,k); left bonds b,c are dim 1
        # (kernel-dispatched site "zipup_first_onelayer": in kernel mode one
        # launch whose output is contiguous, so the reshape is a view)
        v = first_column_onelayer(svec_block[0], row_block[0])
        b, c = v.shape[0], v.shape[1]
        v = v.reshape(b * c, v.shape[2], v.shape[3], v.shape[4])
        j0 = 1
    for j in range(j0, len(svec_block)):
        left, right = einsumsvd(
            svd, [v, svec_block[j], row_block[j]],
            ["aebc", "bfg", "fchk"],
            row="ae", col="hgk", rank=chi, absorb="right", key=keys[j])
        out.append(left)                       # (a, e, m) == (l, d, r)
        v = right                              # (m, h, g, k) -> next (a, e, b, c)
    if last:
        m, h = v.shape[0], v.shape[1]
        out.append(v.reshape(m, h, v.shape[2] * v.shape[3]))
        v = None
    return out, v


def _zipup_row(svec, row, chi, svd, key) -> List[torch.Tensor]:
    """Alg. 3: apply one PEPS row (an MPO) to the boundary MPS ``svec``."""
    out, _ = zipup_block(None, svec, row, chi, svd, _keys(key, len(svec)),
                         first=True, last=True)
    return out


def _mps_to_scalar(svec: List[torch.Tensor]) -> torch.Tensor:
    """Contract an MPS whose dangling (d) indices are all dim 1."""
    acc = torch.ones((1,), dtype=svec[0].dtype, device=svec[0].device)
    for t in svec:
        acc = acc @ t.reshape(t.shape[0], t.shape[2])
    return acc.reshape(())


# ---------------------------------------------------------------------------
# Two-layer: <bra|ket> with layers kept implicit (two-layer IBMPS)
# ---------------------------------------------------------------------------

def zipup_block_twolayer(v: Optional[torch.Tensor],
                         svec_block: Sequence[torch.Tensor],
                         bra_block, ket_block, chi: int, svd,
                         keys: Sequence, first: bool, last: bool):
    """Two-layer sibling of :func:`zipup_block`; carry axes
    ``(a, e1, e2, b, c1, c2)``.  The row's pair bonds stay separate — the
    implicit structure of two-layer IBMPS."""
    out: List[torch.Tensor] = []
    j0 = 0
    if first:
        # S_0:(b,f1,f2,g), bra:(p,f1,c1,h1,k1), ket:(p,f2,c2,h2,k2); b,c1,c2 dim 1
        # (kernel-dispatched site "zipup_first_twolayer": in kernel mode one
        # launch that reads the bra's conj view in place and writes a
        # contiguous output, so the reshape is a view)
        v = first_column_twolayer(svec_block[0], bra_block[0].conj(),
                                  ket_block[0])
        sh = v.shape
        v = v.reshape(sh[0] * sh[1] * sh[2], sh[3], sh[4], sh[5], sh[6], sh[7])
        j0 = 1
    for j in range(j0, len(svec_block)):
        left, right = einsumsvd(
            svd, [v, svec_block[j], bra_block[j].conj(), ket_block[j]],
            ["aeEbcC", "bfFg", "pfchk", "pFCHK"],
            row="aeE", col="hHgkK", rank=chi, absorb="right", key=keys[j])
        out.append(left)                       # (a, e1, e2, m)
        v = right                              # (m, h1, h2, g, k1, k2)
    if last:
        m = v.shape[0]
        out.append(v.reshape(m, v.shape[1], v.shape[2],
                             v.shape[3] * v.shape[4] * v.shape[5]))
        v = None
    return out, v


def _zipup_row_twolayer(svec, bra_row, ket_row, chi, svd,
                        key) -> List[torch.Tensor]:
    """One full row absorption = :func:`zipup_block_twolayer` as one block."""
    out, _ = zipup_block_twolayer(None, svec, bra_row, ket_row, chi, svd,
                                  _keys(key, len(svec)), first=True, last=True)
    return out


def _init_twolayer_boundary(bra_row, ket_row) -> List[torch.Tensor]:
    """First-row boundary: merge only the horizontal pair bonds,
    ``(p,1,l1,d1,r1)* x (p,1,l2,d2,r2) -> (l1 l2, d1, d2, r1 r2)``
    (kernel-dispatched site ``"pair_merge"``: in kernel mode one launch
    whose output is contiguous, so the reshape is a view).  No contraction
    path calls it; the two-layer sweeps start from a trivial boundary."""
    out = []
    for tb, tk in zip(bra_row, ket_row):
        pair = pair_merge(tb.conj(), tk)
        s = pair.shape
        out.append(pair.reshape(s[0] * s[1], s[2], s[3], s[4] * s[5]))
    return out


def _twolayer_final_scalar(svec: List[torch.Tensor]) -> torch.Tensor:
    acc = torch.ones((1,), dtype=svec[0].dtype, device=svec[0].device)
    for t in svec:
        acc = acc @ t.reshape(t.shape[0], t.shape[-1])
    return acc.reshape(())


def trivial_twolayer_boundary(ncol: int, dtype, device) -> List[torch.Tensor]:
    one = torch.ones((1, 1, 1, 1), dtype=dtype, device=device)
    return [one for _ in range(ncol)]


class ZipUpEngine(BoundaryEngine):
    """Row absorption by zip-up truncation (einsumsvd per column).  Its
    row absorption is composable column blocks with one carry tensor
    (:func:`zipup_block`), hence ``supports_blocks``."""
    name = "zipup"
    supports_blocks = True

    def absorb_onelayer(self, svec, row, chi, svd, key):
        return _zipup_row(svec, row, chi, svd, key)

    def absorb_twolayer(self, svec, bra_row, ket_row, chi, svd, key):
        return _zipup_row_twolayer(svec, bra_row, ket_row, chi, svd, key)

    def final_scalar_onelayer(self, svec):
        return _mps_to_scalar(svec)

    def final_scalar_twolayer(self, svec):
        return _twolayer_final_scalar(svec)


register_engine(ZipUpEngine())
