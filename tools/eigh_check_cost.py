#!/usr/bin/env python3
"""Cost of ``svd_grad.eigh_reg``'s retry check on the card.

    PYTHONPATH=src python3 tools/eigh_check_cost.py [--reps 4]

``eigh_reg`` reads back whether a single-precision ``torch.linalg.eigh``
gave finite eigenvalues and eigenvectors, and solves a failed matrix once
more in double precision.  This script times the two workloads it sits on
with three versions of it put in at its call sites (``orthogonalize`` and
``full_update``), in turns (ABC CBA ...) in one process:

* ``committed``: ``eigh_reg`` as committed (one sum of ``w`` and ``v``
  read back);
* ``isfinite_w_v``: the same retry with ``isfinite(w).all() &
  isfinite(v).all()`` read back (five small kernels);
* ``plain``: ``torch.linalg.eigh`` alone, no check and no retry.

The workloads are ``chip_smoke.py``'s: the randomized-BMPS norm of the 8x8
D=6 main-path state (complex64, kernel mode, chi=64), and one full-update
Trotter step of the 4x4 TFI (D=3, chi=12, complex64, kernel mode, ALS
regulariser 1e-6) after three unmeasured steps.  Prints one JSON line per
workload and version (median and all wall times, eigh calls, retries) and
the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from repro_torch.core import full_update as FU  # noqa: E402
from repro_torch.core import orthogonalize as ORTH  # noqa: E402
from repro_torch.core import svd_grad  # noqa: E402
from repro_torch.core.bmps import BMPS, norm_squared  # noqa: E402
from repro_torch.core.ite import trotter_moments, trotter_step  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402
from repro_torch.core.peps import FullUpdate, computational_zeros  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

CALLS = {"eigh": 0}


def _isfinite_w_v(a):
    wide = svd_grad._WIDER.get(a.dtype)
    try:
        w, v = torch.linalg.eigh(a)
        if wide is None or bool(torch.isfinite(w).all()
                                & torch.isfinite(v).all()):
            return w, v
    except torch.linalg.LinAlgError:
        if wide is None:
            raise
    svd_grad.eigh_reg.widened += 1
    w, v = torch.linalg.eigh(a.to(wide))
    return w.to(a.real.dtype), v.to(a.dtype)


VERSIONS = {"committed": svd_grad.eigh_reg, "isfinite_w_v": _isfinite_w_v,
            "plain": torch.linalg.eigh}


def use(version: str) -> None:
    fn = VERSIONS[version]

    def counted(a):
        CALLS["eigh"] += 1
        return fn(a)

    ORTH.eigh_reg = FU.eigh_reg = counted


def timed(run):
    torch.cuda.synchronize()
    calls, widened = CALLS["eigh"], svd_grad.eigh_reg.widened
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, CALLS["eigh"] - calls,
            svd_grad.eigh_reg.widened - widened, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dispatch.set_kernel_backend("kernel")

    rng = np.random.default_rng(C.SEED)
    thetas = rng.uniform(0.0, C.THETA_MAX, size=(C.LAYERS, C.GRID * C.GRID))
    peps8 = C.build_state(torch, C.GRID, C.LAYERS, C.RANK, torch.complex64,
                          thetas)
    option = BMPS.randomized(C.CHI, niter=4, oversample=8)

    tfi = tfi_hamiltonian(C.ITE_GRID, C.ITE_GRID, jz=-1.0, hx=-3.5)
    moments = trotter_moments(tfi, C.ITE_TAU)
    fu = FullUpdate(rank=C.ITE_RANK, chi=C.ITE_ENV_CHI, env_refresh_every=40,
                    als_eps=C.C64_ALS_EPS)
    carry = (computational_zeros(C.ITE_GRID, C.ITE_GRID,
                                 dtype=torch.complex64), TorchKey(C.SEED),
             None, 0)
    for _ in range(3):
        carry = trotter_step(carry[0], moments, fu, *carry[1:])

    workloads = {
        "norm_8x8_c64_kernel": lambda: complex(norm_squared(peps8, option)),
        "fu_step_4x4_c64_kernel": lambda: trotter_step(
            carry[0], moments, fu, *carry[1:])[0].max_bond(),
    }
    order = list(VERSIONS)
    for name, run in workloads.items():
        use("committed")
        run()                                   # warm the caches
        walls = {v: [] for v in order}
        counts = {}
        for rep in range(args.reps):
            for version in (order if rep % 2 == 0 else order[::-1]):
                use(version)
                wall, calls, widened, out = timed(run)
                walls[version].append(wall)
                counts[version] = {"eigh_calls": calls, "widened": widened,
                                   "result": repr(out)}
        base = statistics.median(walls["plain"])
        for version in order:
            med = statistics.median(walls[version])
            print(json.dumps({"workload": name, "version": version,
                              "median_s": med, "walls_s": walls[version],
                              "vs_plain": med / base - 1.0,
                              **counts[version]}), flush=True)
    use("committed")
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
