#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
the hand-written kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``,
sm_90a), holds each kernel against its plain PyTorch version, drives the
port's main path — an 8x8 PEPS built by QR-update gates to bond D=6, its
two-layer IBMPS norm and cached-environment TFI energy at chi=64, and four
one-layer amplitudes — in complex64 through the kernels, then again through
the dense torch path and at complex128, and compares.  Each phase prints
one JSON line; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 1234
GRID = 8                 # 8 x 8 qubits
LAYERS = 3               # RY on every qubit, then CX on every bond
RANK = 6                 # QR-update bond dimension D
CHI = 64                 # boundary bond dimension
N_AMPLITUDES = 4
# RY angles are uniform in [0, THETA_MAX).  With angles up to pi/4 the QR
# updates keep only 3.5e-4 of the norm, and the reference's Gram-QR clamp
# (relative to max(|lambda|, 1.0)) flattens the complex64 contraction of so
# small a network to zero; at 0.3 the norm stays O(1).
THETA_MAX = 0.3

# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TOL_F32 = 1e-5           # kernel vs plain, relative Frobenius, f32
TOL_BF16 = 2e-2          # bf16 multiplicands vs f32 (kernel_bf16_gemm budget)
TOL_SMALL = 1e-4         # 3x3 c64 kernel path vs exact statevector
# The 8x8 comparisons are not rounding comparisons.  The reference
# algorithm's complex64 Gram-QR resolves only singular values above about
# sqrt(1e-6) of the largest, and at D=6, chi=64 the truncated results move
# by about 1e-2 with that noise: measured kernel vs dense 1.2e-2 (norm),
# 1.4e-2 (energy), 1.7e-2 (amplitudes); kernel vs c128 3.1e-2 and 1.6e-2
# (chip, PERF.md).  These bounds catch a broken path, not rounding; the
# kernels themselves are held to TOL_F32 and the small grid to TOL_SMALL.
TOL_FULL = 5e-2          # 8x8: c64 kernel vs c64 dense (norm, energy, amps)
TOL_ANCHOR = 1e-1        # 8x8: c64 kernel vs c128 dense (norm, energy)


class CheckFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel(a, b) -> float:
    return abs(complex(a) - complex(b)) / max(abs(complex(b)), 1e-300)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        vals.append(start.elapsed_time(end) / inner)
    return statistics.median(vals)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch):
    from repro_torch.kernels import gram as KG
    from repro_torch.kernels import matvec as KM
    from repro_torch.kernels import tiled_matmul as KT

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32)

    def compare(name, shape_desc, kernel, plain, bf16):
        got = kernel(None)
        want = plain(None)
        torch.cuda.synchronize()
        err = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
        max_abs = (got - want).abs().max().item()
        line = {"phase": "kernels", "kernel": name, "shape": shape_desc,
                "rel_err": err, "max_abs_err": max_abs}
        check(math.isfinite(err) and err <= TOL_F32,
              f"{name} {shape_desc}: rel err {err} > {TOL_F32}")
        if bf16:
            got16 = kernel("bfloat16")
            want16 = plain("bfloat16")
            torch.cuda.synchronize()
            e_same = (torch.linalg.norm(got16 - want16)
                      / torch.linalg.norm(want16)).item()
            e_f32 = (torch.linalg.norm(got16 - want)
                     / torch.linalg.norm(want)).item()
            line.update(bf16_vs_plain_bf16=e_same, bf16_vs_f32=e_f32)
            check(e_same <= TOL_F32, f"{name} bf16 {shape_desc}: {e_same}")
            check(e_f32 <= TOL_BF16, f"{name} bf16 vs f32 {shape_desc}: {e_f32}")
        return line

    summary = {}

    def measure(name, line, kernel, plain, library, flops, nbytes):
        b_ms, b_by = bound(flops, nbytes)
        line.update(ms=time_ms(torch, lambda: kernel(None)),
                    plain_ms=time_ms(torch, lambda: plain(None)),
                    library_ms=time_ms(torch, library),
                    bound_ms=b_ms, bound_by=b_by)
        line["share_of_bound"] = b_ms / line["ms"]
        summary.setdefault(name, line)

    # -- gram: G = A^T A --------------------------------------------------
    for m, n, main in [(82944, 72, True), (2304, 72, True), (216, 12, False),
                       (216, 24, False), (1000, 1, False), (777, 70, False),
                       (5000, 200, False), (33, 130, False)]:
        a = randn(m, n)
        kern = lambda c, a=a: KG.gram(a, compute=c)
        plain = lambda c, a=a: KG.gram_plain(a, compute=c)
        line = compare("gram", [m, n], kern, plain, bf16=main)
        if main:
            measure("gram", line, kern, plain, lambda a=a: torch.matmul(a.T, a),
                    m * n * (n + 1), 4 * (m * n + n * n))
        emit(line)

    # -- tall_apply: C = A B with B resident --------------------------------
    for m, k, n, main in [(82944, 144, 144, True), (2304, 144, 144, True),
                          (82944, 144, 128, False), (216, 24, 24, False),
                          (1000, 1, 1, False), (1000, 37, 1, False),
                          (777, 70, 200, False), (513, 600, 130, False)]:
        a, b = randn(m, k), randn(k, n)
        kern = lambda c, a=a, b=b: KM.tall_apply(a, b, compute=c)
        plain = lambda c, a=a, b=b: KM.tall_apply_plain(a, b, compute=c)
        line = compare("tall_apply", [m, k, n], kern, plain, bf16=main)
        if main:
            measure("tall_apply", line, kern, plain,
                    lambda a=a, b=b: torch.matmul(a, b),
                    2 * m * k * n, 4 * (m * k + k * n + m * n))
        emit(line)
    try:   # a reduction depth whose slab exceeds shared memory is refused
        KM.tall_apply(randn(64, 900), randn(900, 8))
        raise CheckFailed("tall_apply accepted K=900 beyond shared memory")
    except ValueError as e:
        emit({"phase": "kernels", "kernel": "tall_apply", "shape": [64, 900, 8],
              "refused": str(e)[:120]})

    # -- tiled_matmul: C = op(A) B, split-K --------------------------------
    for m, k, n, trans, main in [(72, 82944, 72, True, True),
                                 (72, 2304, 72, True, True),
                                 (12, 216, 12, True, False),
                                 (1, 5, 1, False, False),
                                 (130, 257, 129, False, False),
                                 (70, 3000, 200, True, False)]:
        a = randn(k, m).T if trans else randn(m, k)
        b = randn(k, n)
        kern = lambda c, a=a, b=b: KT.tiled_matmul(a, b, compute=c)
        plain = lambda c, a=a, b=b: KT.tiled_matmul_plain(a, b, compute=c)
        line = compare("tiled_matmul", [m, k, n], kern, plain, bf16=main)
        line["a_transposed"] = trans
        if main:
            measure("tiled_matmul", line, kern, plain,
                    lambda a=a, b=b: torch.matmul(a, b),
                    2 * m * k * n, 4 * (m * k + k * n + m * n))
        emit(line)
    return summary


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

def bonds(grid: int):
    horiz = [(i * grid + j, i * grid + j + 1)
             for i in range(grid) for j in range(grid - 1)]
    vert = [(i * grid + j, (i + 1) * grid + j)
            for i in range(grid - 1) for j in range(grid)]
    return horiz + vert


def build_state(torch, grid, layers, rank, dtype, thetas, device="cuda"):
    from repro_torch.core import gates
    from repro_torch.core.peps import QRUpdate, apply_operator, \
        computational_zeros
    state = computational_zeros(grid, grid, dtype=dtype, device=device)
    update = QRUpdate(rank=rank)
    cx = gates.gate("CX")
    for layer in range(layers):
        for s in range(grid * grid):
            state = apply_operator(state, gates.gate("RY", thetas[layer, s]), [s])
        for a, b in bonds(grid):
            state = apply_operator(state, cx, [a, b], update)
    return state


def run_main_path(torch, dtype, mode, thetas, bits_list, amplitudes=True):
    from repro_torch.core.bmps import BMPS, amplitude, norm_squared
    from repro_torch.core.expectation import expectation
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.kernels import dispatch

    prev = dispatch.set_kernel_backend(mode)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"dtype": str(dtype).replace("torch.", ""), "mode": mode}
        t0 = time.perf_counter()
        state = build_state(torch, GRID, LAYERS, RANK, dtype, thetas)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        option = BMPS.randomized(CHI, niter=4, oversample=8)
        norm = norm_squared(state, option)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        energy = expectation(state, tfi_hamiltonian(GRID, GRID), option,
                             use_cache=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        amps = ([complex(amplitude(state, bits, option)) for bits in bits_list]
                if amplitudes else [])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        out.update(max_bond=state.max_bond(), norm=complex(norm),
                   energy=complex(energy), amplitudes=amps,
                   gates_s=t1 - t0, norm_s=t2 - t1, energy_s=t3 - t2,
                   amplitudes_s=t4 - t3, total_s=t4 - t0,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        return out, state
    finally:
        dispatch.set_kernel_backend(prev)


def likely_bitstrings(np, thetas, grid: int, count: int):
    """Bitstrings with large amplitudes, so that their relative errors mean
    something in complex64: follow the circuit classically, keeping at each
    RY the more likely bit and applying each CX to the bits exactly.  The
    others flip one of the most balanced qubits of the last RY layer."""
    def trajectory(flip=None):
        bits = np.zeros(grid * grid, dtype=int)
        for layer, th in enumerate(thetas):
            stay = np.abs(np.cos(th / 2)) >= np.abs(np.sin(th / 2))
            bits = np.where(stay, bits, 1 - bits)
            if flip is not None and layer == len(thetas) - 1:
                bits[flip] ^= 1
            for a, b in bonds(grid):
                bits[b] ^= bits[a]
        return bits

    last = thetas[-1]
    balance = np.abs(np.abs(np.cos(last / 2)) - np.abs(np.sin(last / 2)))
    order = np.argsort(balance)
    return [trajectory()] + [trajectory(order[i]) for i in range(count - 1)]


def _as_pair(z: complex):
    return [z.real, z.imag]


def phase_main_path(torch, np):
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.gram import gram
    from repro_torch.kernels.matvec import tall_apply
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    rng = np.random.default_rng(SEED)
    thetas = rng.uniform(0.0, THETA_MAX, size=(LAYERS, GRID * GRID))
    bits_list = likely_bitstrings(np, thetas, GRID, N_AMPLITUDES)

    # the kernel run: every count starts at 0 and is read right after
    dispatch.reset_dispatch_stats()
    for fn in (gram, tall_apply, tiled_matmul):
        fn.launches = 0
    kern, state = run_main_path(torch, torch.complex64, "kernel", thetas,
                                bits_list)
    counters = dispatch.dispatch_stats()
    launches = {"gram": gram.launches, "tall_apply": tall_apply.launches,
                "tiled_matmul": tiled_matmul.launches}

    dense, _ = run_main_path(torch, torch.complex64, "dense", thetas, bits_list)
    anchor, _ = run_main_path(torch, torch.complex128, "dense", thetas,
                              bits_list, amplitudes=False)
    for run in (kern, dense, anchor):
        run["norm"], run["energy"] = _as_pair(run["norm"]), _as_pair(run["energy"])
        run["amplitudes"] = [_as_pair(z) for z in run["amplitudes"]]
        emit({"phase": "main_path", **run})

    def val(run, key):
        return complex(*run[key])

    errs = {
        "norm_kernel_vs_dense": rel(val(kern, "norm"), val(dense, "norm")),
        "energy_kernel_vs_dense": rel(val(kern, "energy"), val(dense, "energy")),
        "amplitudes_kernel_vs_dense": max(
            rel(complex(*a), complex(*b))
            for a, b in zip(kern["amplitudes"], dense["amplitudes"])),
        "norm_kernel_vs_c128": rel(val(kern, "norm"), val(anchor, "norm")),
        "energy_kernel_vs_c128": rel(val(kern, "energy"), val(anchor, "energy")),
    }
    emit({"phase": "main_path", "counters": counters, "launches": launches,
          "errors": errs})
    for run in (kern, dense, anchor):
        for key in ("norm", "energy"):
            check(all(math.isfinite(x) for x in run[key]),
                  f"non-finite {key} in {run['mode']} {run['dtype']}")
        check(run["max_bond"] == RANK, f"bond {run['max_bond']} != {RANK}")
    check(errs["norm_kernel_vs_dense"] <= TOL_FULL, f"norm: {errs}")
    check(errs["energy_kernel_vs_dense"] <= TOL_FULL, f"energy: {errs}")
    check(errs["amplitudes_kernel_vs_dense"] <= TOL_FULL,
          f"amplitudes: {errs}")
    check(errs["norm_kernel_vs_c128"] <= TOL_ANCHOR, f"norm anchor: {errs}")
    check(errs["energy_kernel_vs_c128"] <= TOL_ANCHOR, f"energy anchor: {errs}")
    for site in ("gram", "tall_apply", "zipup_first_onelayer",
                 "zipup_first_twolayer"):
        check(counters[f"kernel_{site}_calls"] > 0,
              f"site {site} never ran through a kernel")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")
    return launches, state


def phase_profile(torch, state):
    """Device time by kernel for one c64 kernel-mode norm of the main-path
    state (torch.profiler), and the device's busy share of the wall time.
    Runs after the main path's counts were read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.bmps import BMPS, norm_squared
    from repro_torch.kernels import dispatch

    option = BMPS.randomized(CHI, niter=4, oversample=8)
    prev = dispatch.set_kernel_backend("kernel")
    try:
        norm_squared(state, option)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            norm_squared(state, option)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dispatch.set_kernel_backend(prev)
    rows = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    emit({"phase": "profile", "what": "norm_squared, complex64, kernel mode",
          "wall_s": wall, "device_s": device_s,
          "device_busy_share": device_s / wall if wall > 0 else None,
          "top": [{"name": k[:100], "calls": c, "device_ms": us / 1e3}
                  for us, k, c in rows[:15]]})


# ---------------------------------------------------------------------------
# A small input against the exact statevector
# ---------------------------------------------------------------------------

def statevector_energy(torch, psi, obs):
    """<psi|H|psi>/<psi|psi> for a (2,)*n state tensor and an Observable."""
    total = 0.0
    for term in obs:
        g = torch.as_tensor(term.gate_tensor(), dtype=psi.dtype,
                            device=psi.device)
        k = len(term.sites)
        phi = torch.tensordot(g, psi, dims=(list(range(k, 2 * k)),
                                            list(term.sites)))
        phi = phi.movedim(tuple(range(k)), tuple(term.sites))
        total = total + term.coeff * torch.vdot(psi.flatten(), phi.flatten())
    return total / torch.vdot(psi.flatten(), psi.flatten())


def phase_small_reference(torch, np):
    """3x3 at an untruncated chi: the c64 kernel path's norm, energy and
    largest amplitude against the exact c128 statevector of the same
    circuit (bonds reach 4 untruncated)."""
    from repro_torch.core.bmps import BMPS, amplitude, norm_squared
    from repro_torch.core.expectation import expectation
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.core.peps import to_statevector
    from repro_torch.kernels import dispatch

    rng = np.random.default_rng(SEED + 1)
    thetas = rng.uniform(0.0, 2.0 * np.pi, size=(2, 9))
    obs = tfi_hamiltonian(3, 3)
    psi = to_statevector(build_state(torch, 3, 2, 4, torch.complex128, thetas))
    bits = np.array(np.unravel_index(int(psi.abs().argmax()), psi.shape))
    want = {"norm": complex(torch.vdot(psi.flatten(), psi.flatten())),
            "energy": complex(statevector_energy(torch, psi, obs)),
            "amplitude": complex(psi[tuple(int(b) for b in bits)])}
    option = BMPS.randomized(32)
    prev = dispatch.set_kernel_backend("kernel")
    try:
        state = build_state(torch, 3, 2, 4, torch.complex64, thetas)
        got = {"norm": complex(norm_squared(state, option)),
               "energy": complex(expectation(state, obs, option)),
               "amplitude": complex(amplitude(state, bits, option))}
    finally:
        dispatch.set_kernel_backend(prev)
    errs = {k: rel(got[k], want[k]) for k in want}
    emit({"phase": "small_reference",
          "port": {k: _as_pair(v) for k, v in got.items()},
          "statevector": {k: _as_pair(v) for k, v in want.items()},
          "rel_err": errs})
    check(max(errs.values()) <= TOL_SMALL, f"3x3 vs statevector: {errs}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()

    from repro_torch.kernels import build
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    try:
        summary = phase_kernels(torch)
        phase_small_reference(torch, np)
        launches, state = phase_main_path(torch, np)
        phase_profile(torch, state)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1

    sources = {"gram": ("src/repro_torch/kernels/csrc/gram.cu",
                        "src/repro/kernels/gram.py:27"),
               "tall_apply": ("src/repro_torch/kernels/csrc/tall_apply.cu",
                              "src/repro/kernels/matvec.py:34"),
               "tiled_matmul": ("src/repro_torch/kernels/csrc/tiled_matmul.cu",
                                "src/repro/kernels/tiled_matmul.py:26")}
    kernels = []
    for name, (source, replaces) in sources.items():
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "shape": s["shape"], "max_abs_err": s["max_abs_err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"],
                        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
