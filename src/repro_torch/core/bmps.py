"""Boundary-MPS contraction of PEPS (paper Alg. 2/3, Section III-B, IV-A).

Counterpart of ``repro.core.bmps``:

* ``contract_onelayer`` — Alg. 2 on a PEPS with no physical indices (BMPS
  with ``DirectSVD``, IBMPS with ``RandomizedSVD``);
* ``contract_twolayer`` — <bra|ket> keeping the two layers implicit
  (two-layer IBMPS when randomized);
* ``contract_exact_onelayer`` — no-truncation reference for small grids.

Boundary tensors are ``(l, d, r)`` (one layer) and ``(l, d_bra, d_ket, r)``
(two layers).  Row absorption is the job of the option's boundary engine
(:mod:`repro_torch.core.engines`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
from repro_torch.core.engines import get_engine
from repro_torch.core.engines.zipup import _keys, trivial_twolayer_boundary
from repro_torch.core.peps import scale_by
from repro_torch.core.precision import resolve_precision, wrap_svd


@dataclasses.dataclass(frozen=True)
class BMPS:
    """Contraction option: boundary-MPS with the given einsumsvd engine.

    ``svd=DirectSVD()`` is the paper's BMPS; ``svd=RandomizedSVD()`` gives
    IBMPS / two-layer IBMPS.  ``chi`` is the truncation bond dimension.
    ``precision`` selects the numerical policy
    (:mod:`repro_torch.core.precision`): ``"exact"`` (default, the bare
    option) or ``"mixed"`` (one-tier storage demotion around each einsumsvd
    solve, bf16 multiplicands in the kernel sites).  The ``svd`` option is
    wrapped at construction, so the engines and the full update inherit
    the policy.  ``"mixed"`` with the kernels holds its budgets on the small
    acceptance cases only: on the H100 the 8x8, D=6 main-path norm at
    chi 64 lands 0.30 from the complex128 one, as a bf16 Gram cannot
    resolve the spectrum that chi keeps (``PERF.md``)."""
    chi: int
    svd: object = DirectSVD()
    engine: object = "zipup"
    precision: object = "exact"

    def __post_init__(self):
        get_engine(self.engine)  # fail fast on unknown engines
        policy = resolve_precision(self.precision)  # fail fast on bad names
        object.__setattr__(self, "svd", wrap_svd(self.svd, policy))

    @classmethod
    def randomized(cls, chi: int, niter: int = 4, oversample: int = 8,
                   fused: bool = True, **kw) -> "BMPS":
        """IBMPS / two-layer IBMPS option with the implicit engine."""
        return cls(chi, svd=RandomizedSVD(niter=niter, oversample=oversample,
                                          fused=fused), **kw)


def _check_option(option) -> None:
    if not isinstance(option, BMPS):
        raise TypeError(f"unknown contraction option "
                        f"{type(option).__name__!r}: expected a BMPS, got "
                        f"{option!r}")


def contract_onelayer(rows: Sequence[Sequence[torch.Tensor]], option: BMPS,
                      key=None) -> torch.Tensor:
    """Alg. 2: contract an (u,l,d,r)-site PEPS to a scalar."""
    _check_option(option)
    eng = get_engine(option.engine)
    nrow = len(rows)
    keys = _keys(key, max(nrow, 2))
    # initial boundary MPS = row 0 with u squeezed: (l, d, r)
    svec = [t.reshape(t.shape[1], t.shape[2], t.shape[3]) for t in rows[0]]
    for i in range(1, nrow):
        svec = eng.absorb_onelayer(svec, rows[i], option.chi, option.svd,
                                   keys[i])
    return eng.final_scalar_onelayer(svec)


def contract_exact_onelayer(rows: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Exact (no truncation) boundary contraction — exponential bond growth."""
    t0 = rows[0][0]
    bound = torch.ones((1,) * len(rows[0]), dtype=t0.dtype, device=t0.device)
    for row in rows:
        bound = bound.reshape((1,) + bound.shape)  # l_run in front
        for j, t in enumerate(row):
            bound = torch.tensordot(bound, t, dims=([j, j + 1], [1, 0]))
            nb = bound.dim()
            bound = bound.movedim((nb - 2, nb - 1), (j, j + 1))
        bound = bound.reshape(bound.shape[:-1])
    return bound.reshape(())


def merge_layers(bra_rows, ket_rows) -> List[List[torch.Tensor]]:
    """Explicitly merge <bra| and |ket> into a one-layer PEPS with pair
    bonds (the memory-hungry object the two-layer algorithms avoid)."""
    out = []
    for bra_row, ket_row in zip(bra_rows, ket_rows):
        row = []
        for tb, tk in zip(bra_row, ket_row):
            pair = torch.einsum("puldr,pULDR->uUlLdDrR", tb.conj(), tk)
            s = pair.shape
            row.append(pair.reshape(s[0] * s[1], s[2] * s[3], s[4] * s[5],
                                    s[6] * s[7]))
        out.append(row)
    return out


def contract_twolayer(bra_rows, ket_rows, option: BMPS, key=None) -> torch.Tensor:
    """<bra|ket> keeping the two layers implicit; the sweep starts from a
    trivial boundary so the first row is truncated as well."""
    _check_option(option)
    eng = get_engine(option.engine)
    nrow = len(bra_rows)
    keys = _keys(key, max(nrow, 2))
    t0 = bra_rows[0][0]
    svec = trivial_twolayer_boundary(len(bra_rows[0]), t0.dtype, t0.device)
    for i in range(nrow):
        svec = eng.absorb_twolayer(svec, bra_rows[i], ket_rows[i],
                                   option.chi, option.svd, keys[i])
    return eng.final_scalar_twolayer(svec)


def amplitude(state, bits, option: BMPS, key=None) -> torch.Tensor:
    """<bits|psi> via approximate one-layer contraction (BMPS/IBMPS): the
    physical index is selected before contracting."""
    bits = np.asarray(bits).reshape(state.nrow, state.ncol)
    rows = [[state.sites[i][j][int(bits[i, j])] for j in range(state.ncol)]
            for i in range(state.nrow)]
    return scale_by(contract_onelayer(rows, option, key), state.log_scale)


def norm_squared(state, option: BMPS, key=None) -> torch.Tensor:
    """<psi|psi> via two-layer contraction."""
    val = contract_twolayer(state.sites, state.sites, option, key)
    return scale_by(val, state.log_scale, 2.0)


def inner(bra, ket, option: BMPS, key=None) -> torch.Tensor:
    """<bra|ket> via two-layer contraction (both PEPS)."""
    val = contract_twolayer(bra.sites, ket.sites, option, key)
    return scale_by(scale_by(val, bra.log_scale), ket.log_scale)
