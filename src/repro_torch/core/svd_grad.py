"""Linear-algebra seam of the einsumsvd stack (forward only).

Counterpart of ``repro.core.svd_grad``.  The reference wraps each
factorization in a ``custom_jvp`` with a degeneracy-regularized derivative;
the port's wrappers are plain ``torch.linalg`` calls with the same names and
return conventions (plain tuples).  The regularized backward comes with the
gradient slice of the port.
"""
from __future__ import annotations

import cmath

import torch


def svd_reg(a: torch.Tensor):
    """Thin SVD ``(u, s, vh)``."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u, s, vh


_WIDER = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def eigh_reg(a: torch.Tensor):
    """Hermitian eigendecomposition ``(w, v)``, ascending ``w``.

    cuSOLVER's single-precision ``heevd`` fails on some finite, strongly
    graded matrices (seen on the H100 in complex64 ITE Grams and
    full-update environments): it raises, or it returns NaN without
    raising, where LAPACK and the double-precision solver succeed.  A
    single-precision result that raised or is not finite is computed once
    more in double precision and cast back; the count of these retries is
    ``eigh_reg.widened``.  The test reads one sum of ``w`` and ``v`` (NaN or
    inf in either shows in it; ``|v| <= 1`` cannot overflow), three small
    kernels and one read after the read ``eigh`` itself makes on the card.
    A non-finite input still gives a non-finite result or raises."""
    wide = _WIDER.get(a.dtype)
    try:
        w, v = torch.linalg.eigh(a)
        if wide is None or cmath.isfinite((w.sum() + v.sum()).item()):
            return w, v
    except torch.linalg.LinAlgError:
        if wide is None:
            raise
    w, v = torch.linalg.eigh(a.to(wide))
    eigh_reg.widened += 1
    return w.to(a.real.dtype), v.to(a.dtype)


eigh_reg.widened = 0


def qr_reg(a: torch.Tensor):
    """Reduced QR ``(q, r)``."""
    q, r = torch.linalg.qr(a)
    return q, r


def sqrt_reg(s: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(s)
