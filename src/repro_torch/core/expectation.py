"""Expectation values of local-term observables on PEPS (Eq. 5, Section IV-B).

Counterpart of ``repro.core.expectation``.  ``expectation(state, obs,
option, use_cache=True)`` evaluates ``<psi|H|psi> / <psi|psi>``:

* with caching: two full environment sweeps, then one strip contraction
  per term;
* without caching: each term pays its own partial two-layer contractions;
* :func:`expectation_trotter`: paper Eq. (6), one two-layer contraction of
  ``<psi|`` against a Trotter-evolved copy of the ket.

Two-site terms are split ``G = sum_k L_k (x) R_k`` (exact operator SVD,
bond kappa <= 4), so any geometry within two adjacent rows reduces to one
column sweep.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import planner
from repro_torch.core.bmps import BMPS, inner, norm_squared
from repro_torch.core.environments import _flip_rows, row_environments, \
    top_environments, trivial_env
from repro_torch.core.gates import trotter_gate
from repro_torch.core.keys import key_or_default
from repro_torch.core.observable import Observable
from repro_torch.core.peps import QRUpdate, apply_operator

#: Seed of the key :func:`expectation` uses when called with ``key=None``.
DEFAULT_EXPECTATION_KEY_SEED = 5
#: Seed of the key :func:`expectation_trotter` uses when called with
#: ``key=None`` (the reference's value).
DEFAULT_TROTTER_KEY_SEED = 21


def split_two_site(gate_tensor: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact SVD split of a (2,2,2,2) gate tensor G[x,y,p,q] into
    L[x,p,kappa], R[y,q,kappa] with G = sum_kappa L (x) R."""
    g = np.asarray(gate_tensor).reshape(2, 2, 2, 2)
    gt = g.transpose(0, 2, 1, 3).reshape(4, 4)  # (x p),(y q)
    u, s, vh = np.linalg.svd(gt)
    k = max(1, int((s > 1e-12 * max(s[0], 1e-300)).sum()))
    left = (u[:, :k] * np.sqrt(s[:k])).reshape(2, 2, k)
    right = (np.sqrt(s[:k])[:, None] * vh[:k]).reshape(k, 2, 2).transpose(1, 2, 0)
    return left, right


def strip_value(top_env: List[torch.Tensor], bottom_env: List[torch.Tensor],
                bra_rows: List[List[torch.Tensor]],
                ket_rows: List[List[torch.Tensor]]) -> torch.Tensor:
    """Exactly contract [top_env; strip rows; bottom_env] left to right.

    Ket tensors may carry one extra trailing "kappa" axis from a split
    two-site operator; the two kappa axes of the strip contract with each
    other.  The bra is conjugated here."""
    ncol = len(top_env)
    nstrip = len(bra_rows)
    counter = [0]

    def fresh() -> int:
        counter[0] += 1
        return counter[0]

    # v core bonds: [top] + [bra, ket]*nstrip + [bottom]; kappa tracked aside
    v_core = [fresh() for _ in range(2 * nstrip + 2)]
    kappa_open = False
    kappa_label: Optional[int] = None
    v = torch.ones((1,) * len(v_core), dtype=top_env[0].dtype,
                   device=top_env[0].device)

    for j in range(ncol):
        args = [v, list(v_core) + ([kappa_label] if kappa_open else [])]
        a_new = fresh()
        f1, f2 = fresh(), fresh()
        args += [top_env[j], [v_core[0], f1, f2, a_new]]
        out_core: List[int] = [a_new]
        up_bra, up_ket = f1, f2
        n_kappa_here = 0
        for t in range(nstrip):
            p = fresh()
            d_bra, d_ket = fresh(), fresh()
            k_bra, k_ket = fresh(), fresh()
            args += [bra_rows[t][j].conj(),
                     [p, up_bra, v_core[1 + 2 * t], d_bra, k_bra]]
            ket_lab = [p, up_ket, v_core[2 + 2 * t], d_ket, k_ket]
            ket_t = ket_rows[t][j]
            if ket_t.dim() == 6:  # carries a split-operator kappa axis
                if kappa_label is None:
                    kappa_label = fresh()
                ket_lab.append(kappa_label)
                n_kappa_here += 1
            args += [ket_t, ket_lab]
            out_core.extend([k_bra, k_ket])
            up_bra, up_ket = d_bra, d_ket
        b_new = fresh()
        args += [bottom_env[j], [v_core[-1], up_bra, up_ket, b_new]]
        out_core.append(b_new)
        # kappa stays open iff exactly one of its two sites is absorbed so far
        open_after = (kappa_open and n_kappa_here == 0) or \
                     (not kappa_open and n_kappa_here == 1)
        args.append(out_core + ([kappa_label] if open_after else []))
        v = planner.int_einsum(*args)
        v_core, kappa_open = out_core, open_after

    return v.reshape(())


def _apply_term_to_ket(strip_ket, term, i0: int, ncol: int):
    """Insert the term's operator into the ket strip (kappa-split form)."""
    out = [[t for t in row] for row in strip_ket]
    like = out[0][0]

    def tensor(x):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)

    if len(term.sites) == 1:
        r, c = divmod(term.sites[0], ncol)
        out[r - i0][c] = torch.einsum("xp,puldr->xuldr", tensor(term.matrix),
                                      out[r - i0][c])
        return out
    ra, ca = divmod(term.sites[0], ncol)
    rb, cb = divmod(term.sites[1], ncol)
    lt, rt = split_two_site(term.gate_tensor())
    out[ra - i0][ca] = torch.einsum("xpk,puldr->xuldrk", tensor(lt),
                                    out[ra - i0][ca])
    out[rb - i0][cb] = torch.einsum("xpk,puldr->xuldrk", tensor(rt),
                                    out[rb - i0][cb])
    return out


def term_rows(term, ncol: int) -> Tuple[int, int]:
    rows = [s // ncol for s in term.sites]
    return min(rows), max(rows)


def _term_value(state, term, top_env, bottom_env) -> torch.Tensor:
    i0, i1 = term_rows(term, state.ncol)
    bra_strip = [state.sites[i] for i in range(i0, i1 + 1)]
    ket_strip = _apply_term_to_ket([list(state.sites[i]) for i in range(i0, i1 + 1)],
                                   term, i0, state.ncol)
    return strip_value(top_env, bottom_env, bra_strip, ket_strip)


def norm_from_envs(state, top, bottom) -> torch.Tensor:
    """<psi|psi> from cached environments (one strip contraction)."""
    i = state.nrow - 1
    return strip_value(top[i], bottom[i], [state.sites[i]], [state.sites[i]])


def expectation_from_envs(state, obs: Observable, top, bottom) -> torch.Tensor:
    """<psi|H|psi>/<psi|psi> from precomputed row environments."""
    total = 0.0
    for term in obs:
        i0, i1 = term_rows(term, state.ncol)
        if i1 - i0 > 1:
            raise NotImplementedError("terms spanning >2 rows need SWAP routing")
        total = total + term.coeff * _term_value(state, term, top[i0], bottom[i1])
    return total / norm_from_envs(state, top, bottom)


def expectation(state, obs: Observable, option: BMPS, use_cache: bool = True,
                key=None) -> torch.Tensor:
    """<psi|H|psi>/<psi|psi> for an Observable H of 1-/2-site terms."""
    key = key_or_default(key, DEFAULT_EXPECTATION_KEY_SEED)
    nrow, ncol = state.nrow, state.ncol
    if use_cache:
        top, bottom = row_environments(state, option, key)
        return expectation_from_envs(state, obs, top, bottom)

    # -- no cache: each term pays its own environment contractions ----------
    total = 0.0
    norm = None
    for term in obs:
        i0, i1 = term_rows(term, ncol)
        if i1 - i0 > 1:
            raise NotImplementedError("terms spanning >2 rows need SWAP routing")
        key, k1, k2 = key.split(3)
        top_env = (trivial_env(ncol, state.dtype, state.device) if i0 == 0 else
                   top_environments(state.sites[:i0], state.sites[:i0],
                                    option, k1)[i0])
        if i1 == nrow - 1:
            bot_env = trivial_env(ncol, state.dtype, state.device)
        else:
            sub = _flip_rows(state.sites[i1 + 1:])
            bot_env = top_environments(sub, sub, option, k2)[len(sub)]
        if norm is None:
            bra_strip = [state.sites[i] for i in range(i0, i1 + 1)]
            norm = strip_value(top_env, bot_env, bra_strip, bra_strip)
        total = total + term.coeff * _term_value(state, term, top_env, bot_env)
    return total / norm


def expectation_trotter(state, obs: Observable, option: BMPS, tau: float = 1e-3,
                        update=None, key=None) -> torch.Tensor:
    """Paper Eq. (6): <H> ~ (<psi|prod_j e^{tau H_j}|psi> - <psi|psi>) / tau.

    One two-layer contraction instead of two, at the price of applying an
    extra (bond-growing, truncated) Trotter step to a copy of the ket; an
    O(tau) bias by construction."""
    key = key_or_default(key, DEFAULT_TROTTER_KEY_SEED)
    if update is None:
        update = QRUpdate(rank=max(4, state.max_bond()))
    phi = state
    for term in obs:
        key, sub = key.split(2)
        g = trotter_gate(-term.coeff * term.matrix, tau)  # exp(+tau c H)
        phi = apply_operator(phi, g, list(term.sites), update, key=sub)
    num = inner(state, phi, option)
    den = norm_squared(state, option)
    return (num - den) / (tau * den)
