"""Linear-algebra seam of the einsumsvd stack (forward only).

Counterpart of ``repro.core.svd_grad``.  The reference wraps each
factorization in a ``custom_jvp`` with a degeneracy-regularized derivative;
the port's wrappers are plain ``torch.linalg`` calls with the same names and
return conventions (plain tuples).  The regularized backward comes with the
gradient slice of the port.
"""
from __future__ import annotations

import torch


def svd_reg(a: torch.Tensor):
    """Thin SVD ``(u, s, vh)``."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u, s, vh


def eigh_reg(a: torch.Tensor):
    """Hermitian eigendecomposition ``(w, v)``, ascending ``w``."""
    w, v = torch.linalg.eigh(a)
    return w, v


def qr_reg(a: torch.Tensor):
    """Reduced QR ``(q, r)``."""
    q, r = torch.linalg.qr(a)
    return q, r


def sqrt_reg(s: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(s)
