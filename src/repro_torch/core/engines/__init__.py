"""Pluggable boundary-absorption engines (counterpart of
``repro.core.engines``).

An engine supplies **row absorption** for the one- and two-layer networks
plus the **final-scalar** closings.  Boundary-MPS layouts are fixed across
engines — one-layer ``(l, d, r)``, two-layer ``(l, d_bra, d_ket, r)``.
Absorption consumes exactly one key per row and derives per-column keys
with ``key.split(ncol)``.  Two engines are built in, registered on first
lookup:

* ``"zipup"`` (:mod:`repro_torch.core.engines.zipup`) — the paper's greedy
  zip-up, one einsumsvd per column (the default);
* ``"variational"`` (:mod:`repro_torch.core.engines.variational`) — an
  ALS-fitted fixed-chi boundary MPS seeded by a zip-up pass.

``supports_blocks`` says whether an engine's row absorption splits into
column blocks with one carry tensor (zip-up does; the variational fit is
row-global), which a column-sharded sweep needs.
"""
from __future__ import annotations

from typing import Dict, List


class BoundaryEngine:
    """Base class / protocol for boundary-absorption engines."""

    name: str = "abstract"
    supports_blocks: bool = False

    def absorb_onelayer(self, svec, row, chi, svd, key) -> List:
        """Absorb an (u,l,d,r)-site MPO row into the one-layer boundary."""
        raise NotImplementedError

    def absorb_twolayer(self, svec, bra_row, ket_row, chi, svd, key) -> List:
        """Absorb a bra/ket row pair ((p,u,l,d,r) sites) into the two-layer
        boundary.  The bra is conjugated by the engine."""
        raise NotImplementedError

    def final_scalar_onelayer(self, svec):
        """Close a fully-absorbed one-layer boundary (dangling dims 1)."""
        raise NotImplementedError

    def final_scalar_twolayer(self, svec):
        """Close a fully-absorbed two-layer boundary (dangling dims 1)."""
        raise NotImplementedError


_REGISTRY: Dict[str, BoundaryEngine] = {}


def register_engine(engine: BoundaryEngine) -> BoundaryEngine:
    """Add an engine to the registry under ``engine.name`` (last wins)."""
    _REGISTRY[engine.name] = engine
    return engine


def _ensure_builtin() -> None:
    # the built-in engines import this module: register them on first
    # lookup to keep the import order acyclic
    if "zipup" not in _REGISTRY:
        from repro_torch.core.engines import zipup  # noqa: F401
    if "variational" not in _REGISTRY:
        from repro_torch.core.engines import variational  # noqa: F401


def registered_engines() -> Dict[str, BoundaryEngine]:
    """Copy of the name -> engine registry."""
    _ensure_builtin()
    return dict(_REGISTRY)


def get_engine(engine) -> BoundaryEngine:
    """Resolve an ``engine`` option value (registered name or instance);
    anything else raises a ``TypeError`` naming the registered engines."""
    _ensure_builtin()
    if isinstance(engine, BoundaryEngine):
        return engine
    if isinstance(engine, str):
        hit = _REGISTRY.get(engine)
        if hit is not None:
            return hit
        raise TypeError(
            f"unknown boundary engine {engine!r}: registered engines are "
            f"{sorted(_REGISTRY)}")
    raise TypeError(
        f"expected a boundary-engine name or BoundaryEngine instance, got "
        f"{engine!r}: registered engines are {sorted(_REGISTRY)}")
