"""Observables: sums of local (1- and 2-site) Hermitian terms.

The port's own copy of ``repro.core.observable`` (numpy only).

An :class:`Observable` is a list of ``Term(sites, matrix, coeff)``.  Sites are
flat qubit indices (row-major over the PEPS grid).  Two-site matrices are
stored as (4, 4); they are converted to (2,2,2,2) gate-tensor layout at
application time.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import numpy as np

from repro_torch.core import gates as G


@dataclasses.dataclass(frozen=True)
class Term:
    sites: Tuple[int, ...]
    matrix: np.ndarray  # (2,2) or (4,4), Hermitian
    coeff: float = 1.0

    def gate_tensor(self) -> np.ndarray:
        """Matrix in gate-tensor layout ((2,2) or (2,2,2,2))."""
        if len(self.sites) == 2:
            return G.two_site_gate(self.matrix)
        return np.asarray(self.matrix)


class Observable:
    """Weighted sum of local Pauli terms, e.g. ``Observable.ZZ(3,4) + 0.2*Observable.X(1)``."""

    def __init__(self, terms: Sequence[Term] = ()):
        self.terms = list(terms)

    # -- constructors -------------------------------------------------------
    @classmethod
    def one_site(cls, pauli: str, site: int, coeff: float = 1.0) -> "Observable":
        return cls([Term((site,), G.pauli_term(pauli), coeff)])

    @classmethod
    def two_site(cls, paulis: str, s0: int, s1: int, coeff: float = 1.0) -> "Observable":
        assert len(paulis) == 2
        return cls([Term((s0, s1), G.pauli_term(paulis), coeff)])

    @classmethod
    def X(cls, site: int) -> "Observable":
        return cls.one_site("X", site)

    @classmethod
    def Y(cls, site: int) -> "Observable":
        return cls.one_site("Y", site)

    @classmethod
    def Z(cls, site: int) -> "Observable":
        return cls.one_site("Z", site)

    @classmethod
    def XX(cls, s0: int, s1: int) -> "Observable":
        return cls.two_site("XX", s0, s1)

    @classmethod
    def YY(cls, s0: int, s1: int) -> "Observable":
        return cls.two_site("YY", s0, s1)

    @classmethod
    def ZZ(cls, s0: int, s1: int) -> "Observable":
        return cls.two_site("ZZ", s0, s1)

    # -- algebra ------------------------------------------------------------
    def __add__(self, other: "Observable") -> "Observable":
        return Observable(self.terms + other.terms)

    def __rmul__(self, c: float) -> "Observable":
        return Observable([dataclasses.replace(t, coeff=t.coeff * c) for t in self.terms])

    __mul__ = __rmul__

    def __iter__(self) -> Iterator[Term]:
        return iter(self.terms)

    def __len__(self) -> int:
        return len(self.terms)

    def as_tuples(self):
        """(sites, gate_tensor, coeff) triples — the statevector oracle format."""
        return [(t.sites, t.gate_tensor(), t.coeff) for t in self.terms]


# ---------------------------------------------------------------------------
# Model Hamiltonians used by the paper's application studies
# ---------------------------------------------------------------------------

def _flat(i: int, j: int, ncol: int) -> int:
    return i * ncol + j


def tfi_hamiltonian(nrow: int, ncol: int, jz: float = -1.0, hx: float = -3.5) -> Observable:
    """Transverse-field Ising model, Eq. (8): H = sum Jz Z_i Z_j + sum hx X_i."""
    obs = Observable()
    for i in range(nrow):
        for j in range(ncol):
            if j + 1 < ncol:
                obs = obs + jz * Observable.ZZ(_flat(i, j, ncol), _flat(i, j + 1, ncol))
            if i + 1 < nrow:
                obs = obs + jz * Observable.ZZ(_flat(i, j, ncol), _flat(i + 1, j, ncol))
            obs = obs + hx * Observable.X(_flat(i, j, ncol))
    return obs


def j1j2_hamiltonian(
    nrow: int,
    ncol: int,
    j1: Sequence[float] = (1.0, 1.0, 1.0),
    j2: Sequence[float] = (0.5, 0.5, 0.5),
    h: Sequence[float] = (0.2, 0.2, 0.2),
) -> Observable:
    """Spin-1/2 J1-J2 Heisenberg model with field, Eq. (7)."""
    obs = Observable()
    paulis = ("XX", "YY", "ZZ")
    singles = ("X", "Y", "Z")
    for i in range(nrow):
        for j in range(ncol):
            s = _flat(i, j, ncol)
            # nearest neighbours
            for (di, dj) in ((0, 1), (1, 0)):
                ii, jj = i + di, j + dj
                if ii < nrow and jj < ncol:
                    for p, c in zip(paulis, j1):
                        if c != 0.0:
                            obs = obs + c * Observable.two_site(p, s, _flat(ii, jj, ncol))
            # diagonal neighbours
            for (di, dj) in ((1, 1), (1, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nrow and 0 <= jj < ncol:
                    for p, c in zip(paulis, j2):
                        if c != 0.0:
                            obs = obs + c * Observable.two_site(p, s, _flat(ii, jj, ncol))
            for p, c in zip(singles, h):
                if c != 0.0:
                    obs = obs + c * Observable.one_site(p, s)
    return obs
