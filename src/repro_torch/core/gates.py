"""Quantum gate library (the port's own copy of ``repro.core.gates``).

Plain numpy constants, converted to torch tensors at the point of use
(:func:`as_tensor`), so the port imports nothing of the reference package.

Conventions
-----------
* Single-qubit gates are ``(2, 2)`` matrices ``G[i, j] = <i|G|j>``.
* Two-qubit gates are ``(2, 2, 2, 2)`` tensors
  ``G[i1, i2, j1, j2] = <i1 i2|G|j1 j2>`` (outputs first, inputs last),
  matching Eq. (2) of the paper.
* All gates are numpy ``complex128``; callers may cast down.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_C = np.complex128

I = np.eye(2, dtype=_C)
X = np.array([[0, 1], [1, 0]], dtype=_C)
Y = np.array([[0, -1j], [1j, 0]], dtype=_C)
Z = np.array([[1, 0], [0, -1]], dtype=_C)
H = np.array([[1, 1], [1, -1]], dtype=_C) / math.sqrt(2)
S = np.array([[1, 0], [0, 1j]], dtype=_C)
T = np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=_C)

# sqrt gates used by random quantum circuits (Arute et al. 2019).
SQRT_X = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=_C)
SQRT_Y = 0.5 * np.array([[1 + 1j, -1 - 1j], [1 + 1j, 1 + 1j]], dtype=_C)
_W = (X + Y) / math.sqrt(2)


def _sqrtm_unitary(u: np.ndarray) -> np.ndarray:
    """Principal square root of a unitary via eigendecomposition."""
    w, v = np.linalg.eig(u)
    return (v * np.sqrt(w.astype(_C))) @ np.linalg.inv(v)


SQRT_W = _sqrtm_unitary(_W)


def RX(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=_C)


def RY(theta: float) -> np.ndarray:
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=_C)


def RZ(theta: float) -> np.ndarray:
    return np.array(
        [[np.exp(-0.5j * theta), 0], [0, np.exp(0.5j * theta)]], dtype=_C
    )


def _two_qubit(mat4: np.ndarray) -> np.ndarray:
    """Reshape a 4x4 matrix (basis order |00>,|01>,|10>,|11>) to (2,2,2,2)."""
    return np.asarray(mat4, dtype=_C).reshape(2, 2, 2, 2)


CX = _two_qubit(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]]
)
CZ = _two_qubit(np.diag([1, 1, 1, -1]))
SWAP = _two_qubit(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]
)
ISWAP = _two_qubit(
    [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]]
)


def CPHASE(phi: float) -> np.ndarray:
    return _two_qubit(np.diag([1, 1, 1, np.exp(1j * phi)]))


def FSIM(theta: float, phi: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return _two_qubit(
        [
            [1, 0, 0, 0],
            [0, c, -1j * s, 0],
            [0, -1j * s, c, 0],
            [0, 0, 0, np.exp(-1j * phi)],
        ]
    )


GATES = {
    "I": I, "X": X, "Y": Y, "Z": Z, "H": H, "S": S, "T": T,
    "SQRT_X": SQRT_X, "SQRT_Y": SQRT_Y, "SQRT_W": SQRT_W,
    "CX": CX, "CNOT": CX, "CZ": CZ, "SWAP": SWAP, "ISWAP": ISWAP,
}

_PARAMETRIC = {"RX": RX, "RY": RY, "RZ": RZ, "CPHASE": CPHASE, "FSIM": FSIM}


def gate(name: str, *params: float) -> np.ndarray:
    """Look up a gate by name, with optional parameters."""
    if name in _PARAMETRIC:
        return _PARAMETRIC[name](*params)
    return GATES[name]


def as_tensor(g, like: torch.Tensor) -> torch.Tensor:
    """Gate ``g`` (a numpy array or a torch tensor) in ``like``'s dtype and
    device.  A tensor is cast with ``.to``, so a gate built from angles that
    require grad stays on the autograd graph."""
    if isinstance(g, torch.Tensor):
        return g.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(g), dtype=like.dtype, device=like.device)


def two_site_gate(mat4: np.ndarray) -> np.ndarray:
    """Public helper: 4x4 matrix -> (2,2,2,2) two-site gate tensor."""
    return _two_qubit(mat4)


# ---------------------------------------------------------------------------
# Hamiltonian terms and Trotter gates
# ---------------------------------------------------------------------------

def pauli_term(names: str) -> np.ndarray:
    """Kronecker product of Pauli matrices, e.g. 'ZZ' or 'X'.

    Returns a (2^k, 2^k) Hermitian matrix.
    """
    mats = {"I": I, "X": X, "Y": Y, "Z": Z}
    out = np.array([[1.0 + 0j]])
    for ch in names:
        out = np.kron(out, mats[ch])
    return out


@lru_cache(maxsize=None)
def _expm_cache(key):
    mat_bytes, shape, tau = key
    h = np.frombuffer(mat_bytes, dtype=_C).reshape(shape)
    return _expm_hermitian(h, tau)


def _expm_hermitian(h: np.ndarray, tau: float) -> np.ndarray:
    """exp(-tau * h) for Hermitian h, via eigendecomposition."""
    w, v = np.linalg.eigh(h)
    return (v * np.exp(-tau * w)) @ v.conj().T


def trotter_gate(h: np.ndarray, tau: float) -> np.ndarray:
    """Imaginary-time-evolution gate exp(-tau*h) for a local Hermitian term.

    Accepts a (2,2) one-site term or a (4,4) two-site term; the latter is
    returned in (2,2,2,2) gate-tensor layout.
    """
    h = np.asarray(h, dtype=_C)
    g = _expm_cache((h.tobytes(), h.shape, float(tau)))
    if g.shape == (4, 4):
        return _two_qubit(g)
    return g
