#!/usr/bin/env python3
"""How the single-precision SVD is taken on the card: accuracy and time.

    PYTHONPATH=src python3 tools/precision_drivers.py [--reps 3]
    PYTHONPATH=src python3 tools/precision_drivers.py --ablations

Three ways to take a complex64 (or float32) thin SVD on the card, put in
for ``svd_grad._svd`` (the forward of every ``svd_reg``) in turns within
one process, for every such SVD:

* ``gesvdj``: ``torch.linalg.svd`` as torch chooses there, cuSOLVER's
  Jacobi ``gesvdj`` (with ``gesvd`` when it fails to converge);
* ``gesvd``: cuSOLVER's QR-iteration ``gesvd``;
* ``double``: the default driver on the matrix widened to double
  precision, the factors cast back.

As committed, ``svd_grad._svd`` takes ``double`` inside the mixed policy's
solves (``wide``) and ``gesvdj`` everywhere else, so the accuracy rows
(mixed runs) of ``double`` and the timing rows (exact runs) of ``gesvdj``
are the committed code's.

Accuracy: the acceptance cases of ``ERROR_BUDGETS`` as ``chip_smoke.py``'s
``robustness`` phase builds them (``precision_cases``), complex128 exact
against mixed, in the dense lane (DirectSVD, storage demotion only) and
the kernel lane (randomized SVD, forced kernel mode), on the card with each
variant and on the CPU (LAPACK, the kernels' plain versions) from the same
inputs; for the dense cases also how close a truncation cut comes to a
degenerate pair (the smallest ``(s[r-1] - s[r]) / s[0]`` over the
contraction's einsumsvd calls, kept rank r).  Time: one complex64
kernel-mode Trotter step of the ``ite`` phase's 4x4 J1-J2 QR update (D=4,
from the Neel state, after three steps) and one complex64 kernel-mode norm
of the 8x8 main-path state, each variant in turns (ABC CBA ...).  One
JSON line per case and variant and per workload, then the card's
``nvidia-smi`` line.

``--ablations`` needs no card: the kernel lane on the CPU (the kernels'
plain versions round to bf16 as the kernels do) with the Gram-QR's two
bf16 repairs taken out, one at a time and both: ``operand_clamp`` clamps
a bf16 Gram's eigenvalues at the operand's eps, ``bf16_reconstitution``
multiplies Q = A R^-1 in bf16 (the reference's Gram-QR does both).
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
import repro_torch.core.einsumsvd  # noqa: E402,F401
from repro_torch.core.bmps import BMPS, norm_squared  # noqa: E402
from repro_torch.core.ite import trotter_moments, trotter_step  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import j1j2_hamiltonian  # noqa: E402
from repro_torch.core.peps import QRUpdate, computational_basis  # noqa: E402
from repro_torch.core.precision import ERROR_BUDGETS  # noqa: E402
from repro_torch.core import orthogonalize as ORTH  # noqa: E402
from repro_torch.core import peps as PEPS_MOD  # noqa: E402
from repro_torch.core import full_update as FU  # noqa: E402
from repro_torch.core import svd_grad  # noqa: E402
from repro_torch.core.svd_grad import eigh_reg  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

# the module (``repro_torch.core`` exports a function of the same name)
ES = sys.modules["repro_torch.core.einsumsvd"]
VARIANTS = ("gesvdj", "gesvd", "double")
SINGLE = (torch.float32, torch.complex64)
COMMITTED = svd_grad._svd
STATE = {"variant": None}


def svd_variant(a, wide):
    """``svd_grad._svd`` as the current variant takes a single-precision
    matrix on the card (``None``: as committed)."""
    name = STATE["variant"]
    if not a.is_cuda or a.dtype not in SINGLE or name is None:
        return COMMITTED(a, wide)
    if name == "gesvd":
        return torch.linalg.svd(a, full_matrices=False, driver="gesvd")
    return COMMITTED(a, name == "double")


ABLATIONS = ("committed", "operand_clamp", "bf16_reconstitution", "neither")
GRAM_QR = ORTH.gram_qr
TALL_PROJECT = ORTH.tall_project
ROUTES_TO_KERNEL = dispatch.routes_to_kernel
RSVD = sys.modules["repro_torch.core.rsvd"]


def ablated_gram_qr(name):
    """``orthogonalize.gram_qr`` with the repairs ``name`` takes out."""
    def gram_qr(a, n_small):
        if name in ("bf16_reconstitution", "neither"):
            ORTH.tall_project = lambda a_, mat, n, own_dtype=False: \
                TALL_PROJECT(a_, mat, n)
        if name in ("operand_clamp", "neither"):
            dispatch.routes_to_kernel = lambda *args, **kwargs: False
        try:
            return GRAM_QR(a, n_small)
        finally:
            ORTH.tall_project = TALL_PROJECT
            dispatch.routes_to_kernel = ROUTES_TO_KERNEL
    return gram_qr


def ablations() -> None:
    cases = C.precision_cases(torch, np, "cpu")[0]
    modules = (ORTH, RSVD, PEPS_MOD, FU)
    prev = dispatch.set_kernel_backend("kernel")
    try:
        for name, fn in cases.items():
            exact = fn("exact", True)
            for variant in ABLATIONS:
                for mod in modules:
                    mod.gram_qr = ablated_gram_qr(variant)
                try:
                    mixed = fn("mixed", True)
                finally:
                    for mod in modules:
                        mod.gram_qr = GRAM_QR
                print(json.dumps({"case": name, "mode": "kernel",
                                  "device": "cpu", "repairs": variant,
                                  "gap": abs(mixed - exact) / abs(exact)}),
                      flush=True)
    finally:
        dispatch.set_kernel_backend(prev)


def accuracy() -> None:
    cuts = []
    svd_reg = ES.svd_reg

    def recording_svd_reg(mat, wide=False):
        u, s, vh = svd_reg(mat, wide)
        cuts.append(s.detach())
        return u, s, vh

    cases = {dev: C.precision_cases(torch, np, dev)[0]
             for dev in ("cuda", "cpu")}
    for mode, randomized in (("dense", False), ("dense", True),
                             ("kernel", True)):
        prev = dispatch.set_kernel_backend(mode)
        try:
            for name in cases["cuda"]:
                if mode == "dense" and randomized and \
                        name != "contract_onelayer":
                    continue
                STATE["variant"] = None
                ES.svd_reg = recording_svd_reg
                cuts.clear()
                exact = cases["cuda"][name]("exact", randomized)
                ES.svd_reg = svd_reg
                rank = 8
                gaps = [float((s[rank - 1] - s[rank]) / s[0])
                        for s in cuts if s.numel() > rank and s[0] > 0]
                for dev, variant in [("cuda", v) for v in VARIANTS] + [
                        ("cpu", "lapack")]:
                    STATE["variant"] = variant
                    widened = eigh_reg.widened
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    try:
                        mixed = cases[dev][name]("mixed", randomized)
                        gap = abs(mixed - exact) / abs(exact)
                    except torch.linalg.LinAlgError as e:
                        gap = repr(e)[:120]
                    torch.cuda.synchronize()
                    print(json.dumps({
                        "case": name, "mode": mode, "randomized": randomized,
                        "device": dev,
                        "svd": variant, "gap": gap,
                        "budget": ERROR_BUDGETS[name]["mixed"],
                        "min_cut_gap": min(gaps) if gaps else None,
                        "eigh_widened": eigh_reg.widened - widened,
                        "mixed_s": time.perf_counter() - t0}), flush=True)
        finally:
            dispatch.set_kernel_backend(prev)
            ES.svd_reg = svd_reg
            STATE["variant"] = None


def timing(reps: int) -> None:
    prev = dispatch.set_kernel_backend("kernel")
    try:
        obs = j1j2_hamiltonian(C.ITE_GRID, C.ITE_GRID)
        neel = np.indices((C.ITE_GRID, C.ITE_GRID)).sum(axis=0) % 2
        moments = trotter_moments(obs, C.ITE_TAU)
        update = QRUpdate(rank=C.J1J2_RANK)
        state, key = computational_basis(neel, dtype=torch.complex64), \
            TorchKey(C.SEED)
        for _ in range(3):
            state, key, _, _ = trotter_step(state, moments, update, key)
        rng = np.random.default_rng(C.SEED)
        thetas = rng.uniform(0.0, C.THETA_MAX, size=(C.LAYERS,
                                                     C.GRID * C.GRID))
        main = C.build_state(torch, C.GRID, C.LAYERS, C.RANK,
                             torch.complex64, thetas)
        option = BMPS.randomized(C.CHI, niter=4, oversample=8)
        work = {"j1j2_c64_kernel_step":
                lambda: trotter_step(state, moments, update, key),
                "main_path_c64_kernel_norm":
                lambda: norm_squared(main, option)}
        for label, fn in work.items():
            times = {v: [] for v in VARIANTS}
            for v in VARIANTS:       # warm every variant once
                STATE["variant"] = v
                fn()
            order = list(VARIANTS)
            for r in range(reps):
                for v in (order if r % 2 == 0 else order[::-1]):
                    STATE["variant"] = v
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[v].append(time.perf_counter() - t0)
            STATE["variant"] = None
            for v in VARIANTS:
                print(json.dumps({"workload": label, "svd": v,
                                  "median_s": statistics.median(times[v]),
                                  "all_s": times[v]}), flush=True)
    finally:
        dispatch.set_kernel_backend(prev)
        STATE["variant"] = None


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--ablations", action="store_true")
    args = parser.parse_args()
    if args.ablations:
        ablations()
        return 0
    if not torch.cuda.is_available():
        print("precision_drivers: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    svd_grad._svd = svd_variant
    try:
        accuracy()
        timing(args.reps)
    finally:
        svd_grad._svd = COMMITTED
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
