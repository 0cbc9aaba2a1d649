"""Quantum circuit generators: random quantum circuits (RQC) and VQE ansatze.

Counterpart of ``repro.core.circuits``.  A circuit is a list of
``(gate, [flat_site, ...])`` moments applied in order.  RQC construction
follows the paper's Section VI-B protocol (after Arute et al. 2019): a
random gate from {sqrt(X), sqrt(Y), sqrt(W)} on every site each layer, and
iSWAP on all neighbouring pairs every four layers.  ``random_circuit`` draws
from the same ``np.random.default_rng(seed)`` stream as the reference, so
both packages build the same gate list.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import gates as G
from repro_torch.core import statevector as sv
from repro_torch.core.keys import TorchKey
from repro_torch.core.peps import DirectUpdate, apply_operator

Circuit = List[Tuple[object, List[int]]]


def _neighbor_pairs(nrow: int, ncol: int) -> List[Tuple[int, int]]:
    pairs = []
    for i in range(nrow):
        for j in range(ncol):
            s = i * ncol + j
            if j + 1 < ncol:
                pairs.append((s, s + 1))
            if i + 1 < nrow:
                pairs.append((s, s + ncol))
    return pairs


def random_circuit(nrow: int, ncol: int, n_layers: int, seed: int = 0,
                   iswap_every: int = 4) -> Circuit:
    """Paper's RQC: per layer a random sqrt-gate on every site (never the
    same one twice in a row); every ``iswap_every`` layers, iSWAP on all
    neighbouring pairs."""
    rng = np.random.default_rng(seed)
    singles = [G.SQRT_X, G.SQRT_Y, G.SQRT_W]
    circuit: Circuit = []
    n = nrow * ncol
    last = -np.ones(n, dtype=int)
    for layer in range(n_layers):
        for s in range(n):
            choices = [k for k in range(3) if k != last[s]]
            k = int(rng.choice(choices))
            last[s] = k
            circuit.append((singles[k], [s]))
        if (layer + 1) % iswap_every == 0:
            for pair in _neighbor_pairs(nrow, ncol):
                circuit.append((G.ISWAP, list(pair)))
    return circuit


def _ry_tensor(theta: torch.Tensor) -> torch.Tensor:
    """Ry(theta) as a real 2x2 tensor on ``theta``'s autograd graph (cast to
    the state's dtype where it is applied)."""
    c, s = torch.cos(theta * 0.5), torch.sin(theta * 0.5)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def vqe_ansatz(nrow: int, ncol: int, thetas: Sequence[float]) -> Circuit:
    """Paper Section VI-D2 ansatz: layers of Ry(theta) on every qubit, each
    followed by CNOT on all nearest-neighbour pairs.

    ``thetas`` has length ``n_layers * nrow * ncol``: numpy angles give
    numpy gates (the reference's), a torch tensor gives gates built with
    ``torch.cos``/``torch.sin``, so autograd traces through the angles."""
    n = nrow * ncol
    if len(thetas) % n:
        raise ValueError("thetas must be a multiple of the qubit count")
    traced = isinstance(thetas, torch.Tensor)
    circuit: Circuit = []
    idx = 0
    for _ in range(len(thetas) // n):
        for s in range(n):
            ry = _ry_tensor(thetas[idx]) if traced else G.RY(float(thetas[idx]))
            circuit.append((ry, [s]))
            idx += 1
        for pair in _neighbor_pairs(nrow, ncol):
            circuit.append((G.CX, list(pair)))
    return circuit


def apply_circuit_peps(state, circuit: Circuit, update, key=None):
    """Run a circuit on a PEPS with the given two-site update option; one
    key split per gate, as in the reference."""
    if key is None:
        key = TorchKey(123)
    for g, sites in circuit:
        key, sub = key.split(2)
        state = apply_operator(state, g, sites, update, key=sub)
    return state


def apply_circuit_exact_peps(state, circuit: Circuit):
    """Run a circuit on a PEPS with NO truncation (exact evolution).

    Bond dimensions grow multiplicatively at every two-site gate; use only
    for the small RQC accuracy studies (the paper does the same)."""
    for g, sites in circuit:
        if len(sites) == 1:
            state = apply_operator(state, g, sites)
            continue
        (i0, j0), (i1, j1) = state.coords(sites[0]), state.coords(sites[1])
        if abs(i0 - i1) + abs(j0 - j1) != 1:
            raise ValueError("exact evolution supports adjacent gates only")
        t0 = state.sites[i0][j0]
        # rank bound = the current shared-bond dim times the gate's rank (4)
        if i0 == i1:
            k = t0.shape[4] if j1 > j0 else t0.shape[2]
        else:
            k = t0.shape[3] if i1 > i0 else t0.shape[1]
        state = apply_operator(state, g, sites, DirectUpdate(rank=4 * k))
    return state


def apply_circuit_statevector(vec: torch.Tensor, circuit: Circuit) -> torch.Tensor:
    for g, sites in circuit:
        vec = sv.apply_gate(vec, g, sites)
    return vec
