"""Exact state-vector simulator — the correctness oracle for every PEPS path.

Counterpart of ``repro.core.statevector``.  The state of ``n`` qubits is a
tensor of shape ``(2,)*n`` (complex128 by default, on the card unless the
caller passes ``device="cpu"``).  Grid site ``(i, j)`` of an
``nrow x ncol`` PEPS maps to qubit ``i*ncol + j``, the paper's row-major
site labelling.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import gates as _gates
from repro_torch.device import resolve_device


def zeros(n: int, dtype=torch.complex128, device=None) -> torch.Tensor:
    """|0...0> on ``n`` qubits."""
    return basis((0,) * n, dtype, device)


def basis(bits: Sequence[int], dtype=torch.complex128,
          device=None) -> torch.Tensor:
    """The computational basis state |bits> on ``len(bits)`` qubits."""
    bits = tuple(int(b) for b in bits)
    state = torch.zeros((2,) * len(bits), dtype=dtype,
                        device=resolve_device(device))
    state[bits] = 1.0
    return state


def apply_gate(state: torch.Tensor, g, sites: Sequence[int]) -> torch.Tensor:
    """Apply a 1- or 2-site gate tensor on the given qubit indices."""
    g = _gates.as_tensor(g, state)
    k = len(sites)
    if k == 1:
        out = torch.tensordot(g, state, dims=([1], [int(sites[0])]))
        return out.movedim(0, int(sites[0]))
    if k == 2:
        a, b = int(sites[0]), int(sites[1])
        out = torch.tensordot(g, state, dims=([2, 3], [a, b]))
        return out.movedim((0, 1), (a, b))    # output axes 0, 1 are sites a, b
    raise ValueError(f"unsupported gate arity {k}")


def amplitude(state: torch.Tensor, bits: Sequence[int]) -> torch.Tensor:
    return state[tuple(int(b) for b in bits)]


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a|b>."""
    return torch.vdot(a.flatten(), b.flatten())


def norm(state: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(inner(state, state).real)


def normalize(state: torch.Tensor) -> torch.Tensor:
    return state / norm(state)


def expectation(state: torch.Tensor, terms) -> torch.Tensor:
    """<psi|H|psi> / <psi|psi> for H given as ``(sites, matrix, coeff)``
    triples (``Observable.as_tuples()``), matrices in gate-tensor layout."""
    total = 0.0
    for sites, mat, coeff in terms:
        total = total + coeff * inner(state, apply_gate(state, mat, sites))
    return total / inner(state, state)
