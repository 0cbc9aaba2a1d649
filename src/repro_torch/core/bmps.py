"""Boundary-MPS contraction of PEPS (paper Alg. 2/3, Section III-B, IV-A).

Counterpart of ``repro.core.bmps``:

* ``contract_onelayer`` — Alg. 2 on a PEPS with no physical indices (BMPS
  with ``DirectSVD``, IBMPS with ``RandomizedSVD``);
* ``contract_twolayer`` — <bra|ket> keeping the two layers implicit
  (two-layer IBMPS when randomized);
* ``contract_exact_onelayer`` — no-truncation reference for small grids;
* ``amplitudes`` — batched <x|psi>: one boundary sweep per shared row
  prefix, then one exact batched close of the final row
  (:func:`final_row_amplitudes`), the primitives of
  :mod:`repro_torch.core.serving`.

Boundary tensors are ``(l, d, r)`` (one layer) and ``(l, d_bra, d_ket, r)``
(two layers).  Row absorption is the job of the option's boundary engine
(:mod:`repro_torch.core.engines`).  Where a ``BMPS`` goes, a
:class:`~repro_torch.core.distributed.DistributedBMPS` runs the same sweep
column-sharded across devices (``amplitudes`` takes a ``BMPS`` only).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import distributed
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
from repro_torch.core.engines import get_engine, registered_engines
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


def _distributed_module(option):
    """:mod:`repro_torch.core.distributed` if ``option`` is a
    ``DistributedBMPS``, None for a :class:`BMPS`; anything else raises a
    ``TypeError`` naming the accepted options and the registered engines."""
    if isinstance(option, BMPS):
        return None
    if isinstance(option, distributed.DistributedBMPS):
        return distributed
    raise TypeError(
        f"unknown contraction option {type(option).__name__!r}: expected a "
        f"BMPS or DistributedBMPS (engine= one of "
        f"{sorted(registered_engines())}), got {option!r}")


def _check_single_device(option, what: str) -> None:
    """Raise the reference's ``TypeError`` where only a single-device
    :class:`BMPS` serves (and for anything that is no option at all)."""
    if _distributed_module(option) is not None:
        raise TypeError(f"{what} serve single-device BMPS options")


def contract_onelayer(rows: Sequence[Sequence[torch.Tensor]], option: BMPS,
                      key=None) -> torch.Tensor:
    """Alg. 2: contract an (u,l,d,r)-site PEPS to a scalar; a
    ``DistributedBMPS`` runs it column-sharded
    (:func:`repro_torch.core.distributed.contract_onelayer`)."""
    dist = _distributed_module(option)
    if dist is not None:
        return dist.contract_onelayer(rows, option, key)
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
    trivial boundary so the first row is truncated as well.  A
    ``DistributedBMPS`` runs it column-sharded."""
    dist = _distributed_module(option)
    if dist is not None:
        return dist.contract_twolayer(bra_rows, ket_rows, option, key)
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


# ---------------------------------------------------------------------------
# Batched amplitudes: shared boundary prefix + batched final-row close
# ---------------------------------------------------------------------------
#
# The one-layer <x|psi> network depends on the bits of row i only from the
# absorption of row i onwards, so queries that share the bits of rows
# 0..nrow-2 share the whole boundary sweep.  The final row's down bonds
# have dimension 1, so absorbing it never truncates: the close equals the
# exact transfer-matrix product of the boundary MPS with the selected
# final-row tensors, a chain of small einsums batched over the queries.

#: Queries per batched close.  A batched GEMM's rounding of one row depends
#: on the batch size, though not on the row's position (H100,
#: ``tools/serve_close_widths.py``: one query closed at B = 1, 2, 4 to 32
#: and 64 rounds four ways; at any of 64 positions of a 64-wide batch, one
#: way), so every close runs at this one width and a query's value does not
#: depend on the queries it was batched with.
CLOSE_WIDTH = 64


def final_row_amplitudes(env, row_sites, bits, log_scale=0.0) -> torch.Tensor:
    """Batched exact close of a boundary MPS against final-row selections.

    ``env`` is the one-layer boundary MPS after absorbing rows
    ``0..nrow-2`` (tensors ``(l, d, r)``); ``row_sites`` the final row's
    ``(p, u, l, d, r)`` site tensors (down bonds dim 1); ``bits`` an integer
    array or tensor ``(B, ncol)`` of final-row bit selections.  Returns the
    ``(B,)`` amplitudes on the sites' device, including
    ``exp(log_scale)``.  The queries are closed in tiles of
    :data:`CLOSE_WIDTH`, the last one padded by repeating its first query,
    through one callable per shape signature
    (:func:`repro_torch.core.planner.fused_fn`, tag ``"serve_close"``)."""
    from repro_torch.core import planner
    t0 = row_sites[0]
    if not torch.is_tensor(bits):
        bits = np.ascontiguousarray(bits)
    bits = torch.as_tensor(bits, dtype=torch.int64, device=t0.device)
    if bits.dim() != 2:
        raise ValueError(f"bits must be (B, ncol), got shape {tuple(bits.shape)}")
    for t in row_sites:
        if t.shape[3] != 1:
            raise ValueError(
                "final_row_amplitudes needs a bottom row (down bonds dim 1); "
                f"got down bond {t.shape[3]}")
    B, W = int(bits.shape[0]), CLOSE_WIDTH
    if B == 0:
        return torch.empty(0, dtype=t0.dtype, device=t0.device)
    ncol = len(env)
    dtype = t0.dtype
    sig = ("serve_close", ncol, W,
           tuple(tuple(t.shape) for t in env),
           tuple(tuple(t.shape) for t in row_sites),
           str(dtype).replace("torch.", ""), t0.device.type)

    def build():
        def run(env_ts, site_ts, bits_arr, log_scale_arr):
            acc = torch.ones((W, 1, 1), dtype=dtype, device=t0.device)
            for j in range(ncol):
                sel = site_ts[j].index_select(0, bits_arr[:, j])
                sel = sel[:, :, :, 0, :]  # (W, u, l, r): squeeze the down bond
                # acc (x=batch, b=env bond, c=row bond) x env_j (b, u, r')
                # x sel (x, u, c, s) -> (x, r', s)
                acc = planner.cached_einsum("xbc,bur,xucs->xrs",
                                            acc, env_ts[j], sel)
            return scale_by(acc.reshape(W), log_scale_arr)
        return run

    fn = planner.fused_fn("serve_close", sig, build)
    if B % W:   # pad the last tile with its first query
        bits = torch.cat([bits, bits[B - B % W].expand(W - B % W, -1)])
    vals = [fn(list(env), list(row_sites), tile, log_scale)
            for tile in bits.split(W)]
    return (vals[0] if len(vals) == 1 else torch.cat(vals))[:B]


def amplitudes(state, bits_batch, option: BMPS, key=None) -> torch.Tensor:
    """Batched <x|psi>: one boundary sweep per shared row prefix.

    ``bits_batch`` is ``(B, nrow*ncol)`` or ``(B, nrow, ncol)``.  Queries
    are grouped by the bits of rows ``0..nrow-2``; each group pays one
    prefix sweep (the keys, engine and einsumsvd sequence of the per-query
    :func:`amplitude`), then one batched exact close of the final row
    (:func:`final_row_amplitudes`).  :mod:`repro_torch.core.serving` adds
    the prefix cache, bucketing and the request queue."""
    from repro_torch.core.environments import onelayer_prefix_environment
    _check_single_device(option, "batched amplitudes")
    bits_arr = np.asarray(bits_batch)
    B = bits_arr.shape[0]
    bits_arr = bits_arr.reshape(B, state.nrow, state.ncol)
    groups: dict = {}
    for idx in range(B):
        prefix = tuple(tuple(int(b) for b in row) for row in bits_arr[idx][:-1])
        groups.setdefault(prefix, []).append(idx)
    vals = torch.empty(B, dtype=state.dtype, device=state.device)
    for prefix, idxs in groups.items():
        env = onelayer_prefix_environment(state, prefix, option, key)
        out = final_row_amplitudes(env, state.sites[-1], bits_arr[idxs, -1, :],
                                   state.log_scale)
        vals[torch.as_tensor(idxs, device=state.device)] = out
    return vals


def norm_squared(state, option: BMPS, key=None) -> torch.Tensor:
    """<psi|psi> via two-layer contraction."""
    val = contract_twolayer(state.sites, state.sites, option, key)
    return scale_by(val, state.log_scale, 2.0)


def inner(bra, ket, option: BMPS, key=None) -> torch.Tensor:
    """<bra|ket> via two-layer contraction (both PEPS)."""
    val = contract_twolayer(bra.sites, ket.sites, option, key)
    return scale_by(scale_by(val, bra.log_scale), ket.log_scale)
