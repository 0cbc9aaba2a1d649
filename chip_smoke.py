#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
the hand-written kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``,
sm_90a; the tensor-core flash and SSD kernels, the Gram kernels, the
tall-apply kernels, the tiled GEMM and the zip-up site kernels must build
without register spills),
holds each kernel against its plain PyTorch version (the tiled GEMM
through ``ops.matmul``, also at a ragged K, a row-major multi-tile output
and a misaligned view, bit for bit on repeat and one launch a call, and
timed with the L2 cold as well as warm; the complex Gram also for exact
Hermiticity and bit-for-bit repeats; the tall-apply and the SSD scan for
bit-for-bit repeats, and the complex tall-apply on conj and strided views
and at a depth K beyond the old shared-memory limit; the zip-up site
kernels, one launch and one device kernel a call, against their plain
versions and einsum at the main and ragged shapes, on conj and strided
views, real and complex, f32 and bf16 (t1's rounding on dyadic operands),
bit for bit on repeat; the bf16 flash kernel
also within a quarter of the gap of a witness that rounds P to bf16, which
the f32 contract forbids, also at Qwen3-4B's and SmolLM-360M's GQA shapes,
and on a probe whose output needs the third bf16 piece of P; the bf16 SSD
scan, at state N = 64 and at mamba2-2.7b's N = 128, within a quarter of
the gap of a witness that rounds its three f32 operands to bf16), drives the port's
main path — an 8x8 PEPS built by QR-update gates to bond D=6, its
two-layer IBMPS norm and cached-environment TFI energy at chi=64, and four
one-layer amplitudes — in complex64 through the kernels, then again through
the dense torch path and at complex128, and compares.  Then it runs
imaginary time evolution on 4x4 grids (``ite`` phase): the TFI model with
the full update at D=3 against the QR update and the exact statevector
ITE, and the J1-J2 model of paper Fig. 13 with the QR update at D=4 from
the Neel state against its statevector ITE, each in complex128 and in
complex64 through the Gram, tall-apply and zip-up kernels, held to each other; each
distinct operand layout that reaches the two kernels in those runs is held
against the kernels' plain versions, and one Trotter step of each model is
profiled.  Then it runs the VQE of paper Fig. 14 (``vqe`` phase, 3x3 TFI,
two ansatz layers): the complex128 energy gradient through the regularized
factorization derivatives against central differences and the exact
statevector gradient, complex64 energies through the two PEPS kernels and
the complex64 gradient (dense: the kernels have no backward, and a forced
kernel mode must refuse a differentiated operand) against complex128, the
adam, SPSA and SLSQP optimizers, and one profiled value-and-grad step.  Then
it holds the robustness slice (``robustness`` phase): the precision
policies' acceptance cases, exact against mixed, in dense mode and in
forced kernel mode (where the demoted complex64 solves run the bf16
instantiations of the Gram and tall-apply kernels, shown by the profiler),
the 8x8 main-path norm under the mixed policy, the runtime guard on the
complex64 full update (clean guarded runs bit for bit the unguarded ones,
six armed faults, the reference's ALS regulariser under a guard), and
checkpoint/resume of ITE (also after a torn write) and of the VQE
optimizers, each resumed run against a fresh one.  Then
it serves
one model of each ported LM family at full width and depth (random bf16
weights from ``SEED``), Zamba2-2.7B (hybrid), Qwen3-4B (dense, GQA 32/8 at
head dimension 128) and Mamba2-2.7B (ssm, SSD state 128): a 4 x 2,048
token prefill through the flash-attention and SSD-scan kernels, 64 greedy
decode steps, the same prefill through the plain versions, a
prefill-then-decode continuation check, and the same weights in f32: kernel
vs plain prefill, the continuation check, and the bf16 model's distance
from its f32 self, which sets the bounds of the bf16 checks.  Each phase
prints JSON lines; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
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

# Imaginary time evolution (ite phase): the full-update acceptance
# configuration of tests/test_full_update.py and
# benchmarks/bench_full_update.py (4x4 TFI, D=3, environments at chi=12
# refreshed once a step, energy at BMPS(16) after 30 steps against the exact
# statevector ITE of 60 steps), and the 4x4 J1-J2 model of paper Fig. 13
# with the QR update at D=4, its energy at BMPS(16) with the randomized SVD,
# from the Neel state (J1-J2 from |0...0>, a near-eigenstate that only the
# 0.2 fields move, departs at a rate set by truncation noise, so two runs
# in different precisions part and neither follows the statevector).
ITE_GRID = 4
ITE_TAU = 0.05
ITE_STEPS = 30
ITE_REF_STEPS = 60
ITE_RANK = 3
ITE_ENV_CHI = 12
ITE_MEASURE_CHI = 16
J1J2_RANK = 4
J1J2_STEPS = 20
# The full update's energy error against the statevector ITE, relative to
# |E_ref| (the reference's acceptance bound).
ITE_FU_TOL = 1e-3
# complex64 ITE energies against the complex128 run of the same
# configuration, and the complex64 kernel-mode run against the complex64
# dense one, relative.  The reference's own J1-J2 complex64 run lies
# 1.38e-4 from its complex128 one (tests/test_torch_ite.py run as a
# script, on the CPU); on the H100 the port's read 5.7e-6 (kernel) and
# 5.6e-5 (dense).
TOL_ITE_C64 = 1e-3
# J1-J2 PEPS energies against the statevector ITE of the same 20 steps,
# relative: the QR update at D=4 truncates the frustrated model, 4.94e-2
# in every precision on the H100 (-28.4018 against -29.8774).  A bound
# that catches a run that leaves the evolution, not rounding.
J1J2_SV_TOL = 1e-1
# The dispatch sites whose kernel forms launch gram_complex and
# tall_apply_complex on the ITE path: the Gram-QR of every reduced split,
# QR update and rSVD, its projections, and the first column of every
# two-layer environment sweep.
ITE_SITES = ("gram", "tall_apply", "zipup_first_twolayer")
# The reference's ALS regulariser, als_eps = 1e-12 (relative to the mean
# diagonal of the normal matrices), is below complex64 rounding: the
# reference's own complex64 full update gives NaN energies at 2x3 on the
# CPU.  A complex64 run that fails at the default runs again at this value,
# and the line says so.
C64_ALS_EPS = 1e-6

# VQE (paper Section VI-D2, Fig. 14): 3x3 TFI at jz = -1, hx = -3.5, two
# layers of Ry on every qubit then CX on every bond (18 angles; the
# configuration of benchmarks/bench_vqe.py and examples/vqe_tfi.py).  At
# rank 4 the two CX layers are exact, and on the CPU chi = 8 gives the
# statevector energy to 1e-14 at four angle draws (chi = 4 misses by
# 2e-2), so one evaluation at (4, 8) is held both to central differences
# and to the statevector.
VQE_GRID = 3
VQE_LAYERS = 2
VQE_RANK = 4
VQE_CHI = 8
VQE_FD_STEP = 1e-5
VQE_FD_RTOL = 1e-4       # AD vs central FD, relative (tests/test_vqe_grad.py)
VQE_FD_COMPONENTS = 3
VQE_SV_TOL = 1e-8        # exact budget: energy vs statevector
# The gradient at the exact budget differs from the statevector's by the
# regularizer itself: at the phase's angles a near-degenerate singular pair
# turns the 1e-12 Lorentzian broadening into 9.004e-8 in the reference and
# in the port alike (CPU, tests/test_torch_vqe.py run as a script).  Held
# at about twice that; central differences hold it at VQE_FD_RTOL.
VQE_SV_GRAD_TOL = 2e-7
# The reference's own complex64 VQE against its complex128 run at this
# setting (tests/test_torch_vqe.py run as a script, CPU, three angle draws
# at each budget): energies up to 2.1e-5 relative, gradients up to 2.4e-4
# of max|g| (at the phase's angles 9.3e-7 and 7.7e-6, 2.3e-5 and 4.1e-5).
# Held at about four times the largest reading.
VQE_C64_ENERGY_TOL = 1e-4
VQE_C64_GRAD_TOL = 1e-3
# The optimizers at the bench's optimizer_convergence budget.
VQE_OPT_RANK = 2
VQE_OPT_CHI = 4
VQE_OPT_ENSEMBLE = 8
VQE_OPT_STEPS = 5
VQE_SLSQP_ITERS = 2
VQE_SITES = ("gram", "tall_apply", "zipup_first_twolayer")
# The kernels every c64 kernel-mode ITE and VQE run must launch: their
# contractions are two-layer, so the one-layer site (zipup_pair) is counted
# but may stay at 0.
TWO_LAYER_KERNELS = ("gram_complex", "tall_apply_complex", "zipup_chain")

# Robustness (robustness phase): the precision policies' acceptance cases
# of ERROR_BUDGETS in complex128, exact against mixed, dense (storage
# demotion, what the table was measured on: held to each row's budget) and
# forced kernel (the demoted complex64 solves multiply in bf16 on
# gram_complex and tall_apply_complex: held to the table's only bf16
# budget, kernel_bf16_gemm's 2e-2; a randomized SVD, so that the solves
# reach the kernels); the 8x8 main-path norm under the mixed policy; the
# runtime guard and checkpoint/resume on the 4x4 TFI full update in
# complex64 kernel mode (the ite phase's configuration with als_eps 1e-6 and
# randomized environment sweeps, so that a corrupted solve has an exact-SVD
# rung to recover on and the kernels run inside guarded solves); and VQE
# resumes at the vqe phase's Fig. 14 setting, QRUpdate(2), BMPS(4).
ROB_KEY_SEED = 17
ROB_QR_STEPS = 10          # the 4x4 TFI D=3 state of contract_twolayer
ROB_GUARD_STEPS = 10       # clean guarded and unguarded runs
ROB_ARMED_STEPS = 3        # each armed run
ROB_MEASURE_EVERY = 2
ROB_RESUME_AT = 6          # the killed run's last step
ROB_CKPT_EVERY = 3
# The full update's bond fidelities in complex64 lie between 0.99999958 and
# 0.99999988 on the H100 (the ite phase's 30-step run): a floor of 0.9999
# is never missed, so the floor sits just above them.
ROB_FIDELITY_FLOOR = 0.9999999
ROB_RESUME_RTOL = 1e-12    # resumed vs fresh energies, relative
ROB_VQE_SPSA_ITERS = 4
ROB_VQE_ADAM_STEPS = 4
ROB_VQE_ENSEMBLE = 2

# Served at full width and depth (lm_serve phases): one model of each
# ported family, hybrid, dense and ssm
LM_ARCHS = ("zamba2-2.7b", "qwen3-4b", "mamba2-2.7b")
LM_BATCH = 4
LM_PROMPT = 2048
LM_DECODE = 64

# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, bf16 on the tensor cores (dense), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Written between the calls of a cold-L2 timing: more than the 50 MB L2.
FLUSH_BYTES = 128 * 2**20
# Cycles the card sleeps before each cold-L2 call (about 1 ms at 1.98 GHz).
SLEEP_CYCLES = 2_000_000

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
# The 8x8 norm under the mixed policy in kernel mode: bf16 Grams clamped at
# bf16's eps cannot resolve the spectrum chi 64 keeps, and the norm reads
# 0.304 to 0.306 from c128 (three runs on the H100, PERF.md).  A regression
# bound, not a budget: the policy does not hold at this size.
TOL_MIXED_MAIN = 0.5
# bf16 outputs of flash_attention / ssd_scan against their plain versions
# on the same bf16 inputs: both round the same f32 result to bf16, and a
# sum taken in another order flips the last bit of a few entries (2^-8).
TOL_BF16_OUT = 4e-3
# The bf16 flash kernel keeps P exact (three bf16 pieces).  At the served
# shape and the ragged GQA shape its gap to the plain version must stay
# under this share of the gap of the plain version with P rounded to bf16,
# read in the same run.
WITNESS_SHARE = 0.25
# ``lo_piece_probe``: an output column that is a difference of two weights
# agreeing in the 16 bits that P's first two bf16 pieces keep.  With all
# three pieces it lies about 1e-2 from its exact value, without the third
# about 0.6.
TOL_LO_PROBE = 1e-1
# lm_serve, kernel vs plain prefill logits in f32: a rounding comparison.
TOL_LM_F32 = 1e-4
# The bf16 rounding floor of the served model is measured, not assumed: the
# plain bf16 prefill against the plain f32 prefill of the same weights.  A
# bf16 model whose logits stray further than this from its f32 self is
# broken, whatever its weights.
TOL_LM_BF16_FLOOR = 1e-1
# bf16 gaps of the served model, kernel vs plain prefill logits and
# prefill + decode vs the longer prefill, are held to twice that floor: each
# side lies about one floor from the f32 logits, so by the triangle
# inequality they differ by at most the sum.
LM_BF16_FLOORS = 2.0
# prefill(t0..t2046) + decode(t2047) vs prefill(t0..t2047) in f32 at full
# width and depth: allclose with rtol = atol = 2e-2, the contract of
# tests/test_models_smoke.py
TOL_DECODE = 2e-2


class CheckFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel(a, b) -> float:
    return abs(complex(a) - complex(b)) / max(abs(complex(b)), 1e-300)


# Kernels that must build without spills: (pattern of the mangled name,
# label, instantiations).  flash_mma_kernel<DP>: one per padded head
# dimension 16, 32, ..., 128; the Gram kernels: <complex, bf16>; the
# tall-apply: <complex, bf16, conj B>, 4 complex and 2 real; the
# chunk-parallel bf16 SSD kernel: <P tiles, N tiles>, P in 1, 2 or 4 and N
# in 1, 2, 4 or 8 tiles of 16; the tiled GEMM: <A transposed, bf16>, and its
# reduce; the zip-up site kernels: <complex, bf16>.
NO_SPILL_KERNELS = ((r"flash_mma_kernelILi(\d+)E", "flash_mma_kernel<{}>", 8),
                    (r"gram_tile_kernelILb(\d)ELb(\d)E",
                     "gram_tile_kernel<{},{}>", 4),
                    (r"gram_reduce_kernelILb(\d)E", "gram_reduce_kernel<{}>",
                     2),
                    (r"tall_apply_kernelILb(\d)ELb(\d)ELb(\d)E",
                     "tall_apply_kernel<{},{},{}>", 6),
                    (r"ssd_chunk_kernelILi(\d)ELi(\d)E",
                     "ssd_chunk_kernel<{},{}>", 12),
                    (r"tiled_matmul_kernelILb(\d)ELb(\d)E",
                     "tiled_matmul_kernel<{},{}>", 4),
                    (r"tiled_matmul_reduce_kernel()",
                     "tiled_matmul_reduce_kernel", 1),
                    (r"zipup_pair_kernelILb(\d)ELb(\d)E",
                     "zipup_pair_kernel<{},{}>", 4),
                    (r"zipup_chain_kernelILb(\d)ELb(\d)E",
                     "zipup_chain_kernel<{},{}>", 4))
# The kernels a bf16 ssd_scan and a bf16 flash_attention call launch (once).
SSD_BF16_KERNEL = "ssd_chunk_kernel"
FLASH_BF16_KERNEL = "flash_mma_kernel"


def no_spill_ptxas(log: str) -> dict:
    """Registers and spill bytes of each instantiation of the kernels in
    ``NO_SPILL_KERNELS``, from the ``-Xptxas -v`` lines of the build log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = None
            for pattern, label, _ in NO_SPILL_KERNELS:
                m = re.search(pattern, ln)
                if m:
                    name = label.format(*m.groups())
                    break
        elif name and "spill stores" in ln:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out.setdefault(name, {}).update(spill_stores=int(stores),
                                            spill_loads=int(loads))
        elif name and "Used" in ln and "registers" in ln:
            out.setdefault(name, {})["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


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


def time_cold_ms(torch, fn, reps: int = 21) -> float:
    """Median over ``reps`` single calls (CUDA events), each after
    ``FLUSH_BYTES`` were written on the card outside the timed events, so
    that the call finds its operands in device memory, not in the L2.  The
    card then sleeps about 1 ms, also outside them, so that the host has
    queued the call before the start event is reached: the time is the
    card's, not the wrapper's."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(1.0)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        vals.append(start.elapsed_time(end))
    return statistics.median(vals)


def bound(nbytes: float, f32_flops: float, bf16_flops: float = 0.0,
          mixed_flops: float = 0.0):
    """(ms, "operations" or "bytes"): the larger of the bytes over the
    memory rate and the operations over the peak for their operands.
    Products of two f32 operands count at the f32 rate; products of two
    bf16 operands at the bf16 tensor-core rate (which multiplies them
    exactly, accumulating in f32); products of an f32 operand with a bf16
    one as three bf16 tensor-core products (the f32 operand split exactly
    into three bf16 pieces, ``flash_attention.split_bf16x3``)."""
    t_ops = (f32_flops / PEAK_F32_FLOPS
             + (bf16_flops + 3 * mixed_flops) / PEAK_BF16_TC_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def measure_line(torch, line, kernel, plain, library, flops, nbytes,
                 bf16_flops=0.0, mixed_flops=0.0):
    """Add the kernel's, the plain version's and the library call's times
    (zero-argument callables; ``library`` may be None) and the bound of
    ``flops`` of two f32 operands, ``bf16_flops`` of two bf16 ones and
    ``mixed_flops`` of an f32 operand with a bf16 one."""
    b_ms, b_by = bound(nbytes, flops, bf16_flops, mixed_flops)
    line.update(ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
                library_ms=None if library is None else time_ms(torch, library),
                bound_ms=b_ms, bound_by=b_by,
                flops=flops + bf16_flops + mixed_flops,
                bf16_flops=bf16_flops, mixed_flops=mixed_flops, bytes=nbytes)
    line["share_of_bound"] = b_ms / line["ms"]
    if mixed_flops:
        # the count before the exact split: mixed products at the f32 rate
        line["bound_ms_mixed_at_f32_rate"] = bound(
            nbytes, flops + mixed_flops, bf16_flops)[0]


def rel_gap(torch, got, want) -> float:
    """Relative Frobenius distance of ``got`` from ``want``, in f32 or c64."""
    if not got.is_complex():
        got, want = got.float(), want.float()
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


def held(torch, name, shape, got, want, tol, **extra):
    """Hold ``got`` against ``want`` (relative Frobenius error, in f32 or
    c64); the kernels-phase line of one comparison."""
    torch.cuda.synchronize()
    err = rel_gap(torch, got, want)
    if not got.is_complex():
        got, want = got.float(), want.float()
    line = {"phase": "kernels", "kernel": name, "shape": shape,
            "rel_err": err, "max_abs_err": (got - want).abs().max().item(),
            "tol": tol, **extra}
    check(math.isfinite(err) and err <= tol,
          f"{name} {shape} {extra}: rel err {err} > {tol}")
    return line


def phase_kernels(torch):
    from repro_torch.kernels import gram as KG
    from repro_torch.kernels import matvec as KM
    from repro_torch.kernels import ops as KO
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
        measure_line(torch, line, lambda: kernel(None), lambda: plain(None),
                     library, flops, nbytes)
        summary.setdefault(name, line)

    def crandn(*shape):
        return torch.complex(randn(*shape), randn(*shape))

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

    # -- gram_complex: G = A^H A of c64 A, its storage read once -----------
    #    the main path's shapes (measured), then odd ones
    for m, n, main in [(82944, 72, True), (46656, 72, True), (82944, 36, True),
                       (2304, 72, True), (1296, 72, False), (36, 36, False),
                       (1, 1, False), (2304, 1, False), (5000, 200, False),
                       (33, 130, False)]:
        a = crandn(m, n)
        kern = lambda c, a=a: KG.gram_complex(a, compute=c)
        plain = lambda c, a=a: KG.gram_complex_plain(a, compute=c)
        line = compare("gram_complex", [m, n], kern, plain, bf16=True)
        for c in (None, "bfloat16"):
            g = kern(c)
            check(torch.equal(g.real, g.real.T)
                  and torch.equal(g.imag, -g.imag.T),
                  f"gram_complex {[m, n]} {c}: not exactly Hermitian")
            check(torch.equal(kern(c), g),
                  f"gram_complex {[m, n]} {c}: a second call differs")
        line["hermitian_and_repeats_bitwise"] = True
        if main:
            measure("gram_complex", line, kern, plain,
                    lambda a=a: torch.matmul(a.mH, a), 4 * m * n * n,
                    8 * (m * n + n * n))
        emit(line)

    # -- tall_apply: C = A B, B staged over K; K = 900 is beyond the depth
    #    the old resident slab of B could hold in shared memory -------------
    for m, k, n, main in [(82944, 144, 144, True), (2304, 144, 144, True),
                          (82944, 144, 128, False), (216, 24, 24, False),
                          (1000, 1, 1, False), (1000, 37, 1, False),
                          (777, 70, 200, False), (513, 600, 130, False),
                          (64, 900, 8, False)]:
        a, b = randn(m, k), randn(k, n)
        kern = lambda c, a=a, b=b: KM.tall_apply(a, b, compute=c)
        plain = lambda c, a=a, b=b: KM.tall_apply_plain(a, b, compute=c)
        line = compare("tall_apply", [m, k, n], kern, plain, bf16=main)
        check(torch.equal(kern(None), kern(None)),
              f"tall_apply {[m, k, n]}: a second call differs")
        if main:
            measure("tall_apply", line, kern, plain,
                    lambda a=a, b=b: torch.matmul(a, b),
                    2 * m * k * n, 4 * (m * k + k * n + m * n))
        emit(line)

    # -- tall_apply_complex: C = A B of c64 A read in place -----------------
    #    the main path's shapes (measured), then odd ones and K = 488
    for m, k, n, main in [(82944, 72, 72, True), (82944, 72, 64, True),
                          (46656, 72, 72, True), (2304, 72, 72, True),
                          (1296, 72, 72, True), (1, 1, 1, False),
                          (777, 70, 200, False), (64, 488, 8, False)]:
        a, b = crandn(m, k), crandn(k, n)
        kern = lambda c, a=a, b=b: KM.tall_apply_complex(a, b, compute=c)
        plain = lambda c, a=a, b=b: KM.tall_apply_complex_plain(a, b,
                                                                compute=c)
        line = compare("tall_apply_complex", [m, k, n], kern, plain,
                       bf16=True)
        for c in (None, "bfloat16"):
            check(torch.equal(kern(c), kern(c)),
                  f"tall_apply_complex {[m, k, n]} {c}: a second call differs")
        line["repeats_bitwise"] = True
        if main:
            measure("tall_apply_complex", line, kern, plain,
                    lambda a=a, b=b: torch.matmul(a, b), 8 * m * k * n,
                    8 * (m * k + k * n + m * n))
        emit(line)
    # rSVD's projection q_t.conj() @ vh_small.T: a conj view of A and a
    # transposed slice of B, read through their conj bits and strides
    a, vh = crandn(82944, 72), crandn(72, 72)[:64]
    line = compare("tall_apply_complex", [82944, 72, 64],
                   lambda c: KM.tall_apply_complex(a.conj(), vh.T, compute=c),
                   lambda c: KM.tall_apply_complex_plain(a.conj(), vh.T,
                                                         compute=c),
                   bf16=True)
    line["operands"] = "a.conj(), vh[:64].T"
    emit(line)

    # -- tiled_matmul through ops.matmul: C = op(A) B, 72 x 72 block tiles,
    #    split over K.  The main shapes (measured), small ones, a row-major
    #    multi-tile output, a ragged K, and views one float into their
    #    storage (no 16-byte copy aligned)
    def tiled_operands(m, k, n, trans, offset):
        def view(rows, cols):
            return randn(rows * cols + offset)[offset:].view(rows, cols)
        return (view(k, m).T if trans else view(m, k)), view(k, n)

    for m, k, n, trans, offset, main in [
            (72, 82944, 72, True, 0, True), (72, 2304, 72, True, 0, True),
            (12, 216, 12, True, 0, False), (1, 5, 1, False, 0, False),
            (130, 257, 129, False, 0, False), (70, 3000, 200, True, 0, False),
            (200, 3000, 130, False, 0, False),
            (72, 82943, 72, True, 0, False), (72, 82944, 72, True, 1, False)]:
        a, b = tiled_operands(m, k, n, trans, offset)
        kern = lambda c, a=a, b=b: KO.matmul(a, b, compute=c)
        plain = lambda c, a=a, b=b: KT.tiled_matmul_plain(a, b, compute=c)
        line = compare("tiled_matmul", [m, k, n], kern, plain, bf16=main)
        line.update(entry="ops.matmul", a_transposed=trans,
                    offset_floats=offset)
        if main:
            measure("tiled_matmul", line, kern, plain,
                    lambda a=a, b=b: torch.matmul(a, b),
                    2 * m * k * n, 4 * (m * k + k * n + m * n))
        if main and k == 82944:
            for c in (None, "bfloat16"):
                before = KT.tiled_matmul.launches
                got = kern(c)
                check(KT.tiled_matmul.launches == before + 1,
                      f"tiled_matmul {[m, k, n]} {c}: one ops.matmul call "
                      f"launched {KT.tiled_matmul.launches - before} times")
                check(torch.equal(kern(c), got),
                      f"tiled_matmul {[m, k, n]} {c}: a second call differs")
            line.update(launches_per_call=1, repeats_bitwise=True)
            # the operands' 47.8 MB nearly fit the 50 MB L2, which a warm
            # loop reads in part: the share of the bound is the cold one
            line["ms_cold"] = time_cold_ms(torch, lambda: kern(None))
            line["library_ms_cold"] = time_cold_ms(
                torch, lambda a=a, b=b: torch.matmul(a, b))
            line["share_of_bound_warm"] = line["share_of_bound"]
            line["share_of_bound"] = line["bound_ms"] / line["ms_cold"]
        emit(line)
    return summary


# The zip-up sites: (dispatch site, kernel of csrc/zipup_block.cu, plain
# version's name, einsum, g of the main shape, its flops) at D = 6, chi =
# 64 (the interior columns of the 8x8 path), then ragged (D, g): p = 2,
# u = U = 2 in the pair merge.
ZIPUP_SITES = (
    # S0 (1,6,6) x O0 (6,1,6,6): (6 x 6) @ (6 x 36)
    ("zipup_first_onelayer", "zipup_pair", "first_onelayer_plain",
     "bfg,fchk->bchgk", 6, 8 * 6 * 6 * 36),
    # S0 (1,6,6,36) x bra (2,6,1,6,6) x ket: (216 x 6) @ (6 x 72), then
    # (1296 x 12) @ (12 x 36)
    ("zipup_first_twolayer", "zipup_chain", "first_twolayer_plain",
     "bfFg,pfchk,pFCHK->bcChHgkK", 36, 8 * (216 * 6 * 72 + 1296 * 12 * 36)),
    # first-row D = 6 bra/ket sites (2,1,6,6,6): (216 x 2) @ (2 x 216)
    ("pair_merge", "zipup_pair", "pair_merge_plain", "puldr,pULDR->lLdDrR",
     0, 8 * 216 * 2 * 216),
)
ZIPUP_RAGGED = ((2, 1), (3, 7), (4, 36), (8, 128), (8, 1), (2, 128))


def zipup_shapes(site, d, g, main=False):
    """The operand shapes of a zip-up site at bond D and boundary bond g
    (``main``: the main path's, whose pair merge has u = U = 1)."""
    if site == "zipup_first_onelayer":
        return [(1, d, g), (d, 1, d, d)]
    if site == "zipup_first_twolayer":
        return [(1, d, d, g), (2, d, 1, d, d), (2, d, 1, d, d)]
    u = 1 if main else 2
    return [(2, u, d, d, d), (2, u, d, d, d)]


def t1_flip_tol(xs):
    """The two-layer site with bf16 multiplicands on normal inputs against
    its plain version: a t1 entry within a sum-order rounding of a bf16 tie
    rounds the other way (2^-8 of that entry); four such flips of average
    entries, ten times inside the witness that skips t1's rounding
    (``tests/test_torch_zipup_block.py``).  On dyadic inputs, where t1 is
    exact in f32, the kernel is held at TOL_F32."""
    b, f, F, g = xs[0].shape
    p, _, c, h, k = xs[1].shape
    return max(TOL_F32, 2.0 ** -8 * (4.0 / (b * F * g * p * c * h * k)) ** 0.5)


def profiled_kernels(torch, fn, calls):
    """Device kernels of ``calls`` calls of ``fn`` under torch.profiler:
    {name: (count, mean device ms)}."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = (evt.count, us / 1e3 / max(evt.count, 1))
    return out


def phase_wrappers(torch):
    """``planar_matmul`` and the three zip-up sites on the card.  The
    wrapper is held against the same function built from its kernel's plain
    version; each zip-up site's kernel form (one launch of
    ``zipup_pair_kernel`` or ``zipup_chain_kernel``) against its plain
    version and its dense einsum, at the main path's shapes and ragged ones,
    on conj and strided views, real and complex, with f32 and bf16
    multiplicands; at the main shapes also for one launch a call, a bit
    for bit repeat, one device kernel in a profiled call, and its times.
    Returns the one-layer and two-layer sites' lines for the kernels
    line."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import matvec as KM
    from repro_torch.kernels import zipup_block as Z

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def crandn(*shape):
        re, im = (torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(2))
        return torch.complex(re, im)

    # -- planar_matmul: complex A B as one tall_apply_complex launch,
    #    against the reference's planar form in plain torch
    m, k, n = 82944, 72, 72
    a, b = crandn(m, k), crandn(k, n)

    def planar_plain():
        return KM.tall_apply_complex_plain(a, b)

    line = held(torch, "planar_matmul", [m, k, n], KM.planar_matmul(a, b),
                planar_plain(), TOL_F32, dtype="complex64")
    measure_line(torch, line, lambda: KM.planar_matmul(a, b), planar_plain,
                 lambda: torch.matmul(a, b), 8 * m * k * n,
                 8 * (m * k + k * n + m * n))
    emit(line)

    def operands(site, d, g, dtype, layout, main=False, dyadic=False):
        def part(shape):
            if dyadic:   # k / 128, |k| <= 255: bf16 values, exact sums
                return torch.randint(-255, 256, shape, generator=gen,
                                     device="cuda").float() / 128
            return torch.randn(shape, generator=gen, device="cuda")
        xs = [torch.complex(part(s), part(s)) if dtype == "complex64"
              else part(s) for s in zipup_shapes(site, d, g, main)]
        if layout == "views":
            # S0 as a permuted view, the bra as a conj view (as the engine
            # passes it), the ket as every other entry of a longer axis
            perm = list(range(1, xs[0].dim())) + [0]
            back = [xs[0].dim() - 1] + list(range(xs[0].dim() - 1))
            xs[0] = xs[0].permute(back).contiguous().permute(perm)
            if site != "zipup_first_onelayer":
                bra = 0 if site == "pair_merge" else 1
                xs[bra] = xs[bra].conj()
                wide = torch.zeros(xs[-1].shape[:-1]
                                   + (2 * xs[-1].shape[-1],),
                                   dtype=xs[-1].dtype, device="cuda")
                wide[..., ::2] = xs[-1]
                xs[-1] = wide[..., ::2]
        return xs

    def run(site, xs, compute):
        prev = dispatch.set_kernel_compute(compute)
        try:
            return dispatch.site(site).kernel_fn(*xs)
        finally:
            dispatch.set_kernel_compute(prev)

    summary = {}
    for site, kernel, plain_name, expr, main_g, flops in ZIPUP_SITES:
        plain = getattr(Z, plain_name)
        dense = dispatch.site(site).dense_fn
        # -- every shape, layout, dtype and compute against the plain
        #    version; with f32 multiplicands also against the dense einsum
        cases, worst = 0, {"vs_plain": 0.0, "vs_dense": 0.0, "bf16_t1": 0.0}
        shapes = [(6, main_g, True)] + [(d, g, False)
                                        for d, g in ZIPUP_RAGGED]
        for d, g, main in shapes:
            for dtype in ("complex64", "float32"):
                for layout in ("contiguous", "views"):
                    xs = operands(site, d, g, dtype, layout, main)
                    for compute in (None, "bfloat16"):
                        got = run(site, xs, compute)
                        want = plain(*xs, compute)
                        tol = TOL_F32
                        if compute and site == "zipup_first_twolayer":
                            tol = t1_flip_tol(xs)
                        err = rel_gap(torch, got, want)
                        check(got.is_contiguous() and got.shape == want.shape
                              and str(got.dtype) == f"torch.{dtype}"
                              and math.isfinite(err) and err <= tol,
                              f"{site} {[list(x.shape) for x in xs]} {dtype} "
                              f"{layout} {compute}: rel err {err} > {tol}")
                        worst["vs_plain"] = max(worst["vs_plain"], err / tol)
                        if compute is None:
                            err = rel_gap(torch, got, dense(*xs))
                            check(err <= TOL_F32, f"{site} vs dense: {err}")
                            worst["vs_dense"] = max(worst["vs_dense"], err)
                        cases += 1
        if site == "zipup_first_twolayer":
            # t1 rounded where the plain version rounds it: on dyadic
            # operands t1 is exact in f32, and the witness that skips its
            # rounding misses
            for d, g in ((6, 36), (8, 128)):
                xs = operands(site, d, g, "complex64", "views", dyadic=True)
                want = plain(*xs, "bfloat16")
                err = rel_gap(torch, run(site, xs, "bfloat16"), want)
                gap = rel_gap(torch, torch.einsum(expr, *xs), want)
                check(err <= TOL_F32 and gap > 10 * TOL_F32,
                      f"{site} t1 rounding: {err}, witness {gap}")
                worst["bf16_t1"] = max(worst["bf16_t1"], err)
        # -- the main shape, timed first (profiling can slow the launches
        #    after it): on contiguous operands, and on views (the bra a conj
        #    view, S0 and the ket strided)
        xs = operands(site, 6, main_g, "complex64", "contiguous", main=True)
        views = operands(site, 6, main_g, "complex64", "views", main=True)
        fn = lambda s=site, xs=xs: run(s, xs, None)
        fn_views = lambda s=site, xs=views: run(s, xs, None)
        want = plain(*views)
        line = held(torch, site, [list(x.shape) for x in xs], fn_views(),
                    want, TOL_F32, dtype="complex64", kernel_name=kernel,
                    form="kernel vs plain, bra conj view, S0 and ket strided",
                    cases=cases, worst=worst)
        line["max_abs_err_vs_dense"] = (
            fn_views() - dense(*views)).abs().max().item()
        measure_line(torch, line, fn, lambda p=plain, xs=xs: p(*xs),
                     lambda e=expr, xs=xs: torch.einsum(e, *xs), flops,
                     8 * (sum(x.numel() for x in xs) + want.numel()))
        line["views"] = {
            "ms": time_ms(torch, fn_views),
            "plain_ms": time_ms(torch, lambda p=plain, xs=views: p(*xs)),
            "library_ms": time_ms(torch, lambda e=expr, xs=views:
                                  torch.einsum(e, *xs))}
        # -- one launch a call, a bitwise repeat, one device kernel
        for args in (xs, views):
            for compute in (None, "bfloat16"):
                before = Z.kernel_launches()
                before_ta = KM.tall_apply_complex.launches
                got = run(site, args, compute)
                after = Z.kernel_launches()
                check(after[kernel] == before[kernel] + 1
                      and sum(after.values()) == sum(before.values()) + 1
                      and KM.tall_apply_complex.launches == before_ta,
                      f"{site} {compute}: launches {before} -> {after}")
                check(torch.equal(run(site, args, compute), got),
                      f"{site} {compute}: a second call differs")
        for call in (fn, fn_views):
            one = profiled_kernels(torch, call, 1)
            check(len(one) == 1 and all(kernel + "_kernel" in k and c == 1
                                        for k, (c, _) in one.items()),
                  f"{site}: one call ran the device kernels {one}")
        many = profiled_kernels(torch, fn, 50)
        line.update(launches_per_call=1, repeats_bitwise=True,
                    profiled_kernels=sorted(one),
                    device_ms=sum(ms * c for c, ms in many.values()) / 50)
        line["host_share"] = 1 - line["device_ms"] / line["ms"]
        emit(line)
        if site != "pair_merge":    # the pair merge is on no path yet
            summary[kernel] = line
    return summary


def ssd_flops_bytes(bh, length, p, n, chunk, itemsize, state):
    """(C B^T flops, flops of the products of an f32 operand with an input,
    bytes): the operations the SSD scan needs (the causal half of each
    chunk's score tile; C B^T multiplies two inputs, while (C B^T * L) x,
    C h and the state update (w * B)^T x each pair an f32 operand, the
    decayed scores, the state or the decay-weighted B, with an input) and
    the bytes it must move (x, B, C read, y written, a in f32, the final
    f32 state when returned).  For bf16 inputs the second kind counts as
    three bf16 tensor-core products (``bound``)."""
    cb = other = 0
    for t0 in range(0, length, chunk):
        t = min(chunk, length - t0)
        cb += t * (t + 1) * n
        other += t * (t + 1) * p + 4 * t * n * p
    nbytes = length * (itemsize * (2 * p + 2 * n) + 4) + (4 * n * p if state
                                                          else 0)
    return bh * cb, bh * other, bh * nbytes


def phase_lm_kernels(torch):
    """``flash_attention`` and ``ssd_scan`` against their plain versions,
    at the served Zamba2 shapes and at small ragged ones."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import ssd_scan as KS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen,
                                    device="cuda")).to(dtype)

    def within_witness(line, q, k, v, want, causal):
        # The f32 contract, where it can be seen: the plain version with P
        # rounded to bf16 (the witness) against the plain version.  The
        # bf16 kernel keeps P exact, so it must lie well inside that gap.
        witness = rel_gap(torch, KF.flash_attention_split_plain(
            q, k, v, causal=causal, pieces=1), want)
        line["witness_p_bf16_vs_plain"] = witness
        check(line["rel_err"] <= WITNESS_SHARE * witness,
              f"flash_attention bf16 {line['shape']}: kernel vs plain "
              f"{line['rel_err']} > {WITNESS_SHARE} x the P-in-bf16 witness "
              f"{witness}")

    summary = {}
    # -- flash_attention: the served shape, in the model's (B, S, H, D)
    #    storage, then GQA with a ragged S, then the third piece of P
    b, h, s, d = LM_BATCH, 32, LM_PROMPT, 80
    for dtype, main in ((torch.bfloat16, True), (torch.float32, False)):
        q, k, v = (randn(b, s, h, d, dtype=dtype).transpose(1, 2)
                   for _ in range(3))
        kern = lambda q=q, k=k, v=v: KF.flash_attention(q, k, v, causal=True)
        plain = lambda q=q, k=k, v=v: KF.flash_attention_plain(q, k, v,
                                                               causal=True)
        got, want = kern(), plain()
        line = held(torch, "flash_attention", [b, h, s, d], got, want,
                    TOL_BF16_OUT if main else TOL_F32,
                    dtype=str(dtype).replace("torch.", ""), causal=True)
        if main:
            within_witness(line, q, k, v, want, True)
            line["split3_vs_plain"] = rel_gap(
                torch, KF.flash_attention_split_plain(q, k, v, causal=True),
                want)
            # each product over the causal half: Q K^T of two bf16
            # operands, P V of f32 P with bf16 V
            product = s * (s + 1) * d * b * h
            nbytes = 2 * 4 * b * h * s * d
            measure_line(torch, line, kern, plain,
                         lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                             q, k, v, is_causal=True), 0.0, nbytes,
                         bf16_flops=product, mixed_flops=product)
            summary["flash_attention"] = line
        del got, want
        emit(line)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            q = randn(1, 4, 300, 80, dtype=dtype)
            k, v = (randn(1, 2, 300, 80, dtype=dtype) for _ in range(2))
            want = KF.flash_attention_plain(q, k, v, causal=causal)
            line = held(torch, "flash_attention", [1, 4, 2, 300, 80],
                        KF.flash_attention(q, k, v, causal=causal), want,
                        TOL_F32 if dtype == torch.float32 else TOL_BF16_OUT,
                        dtype=str(dtype).replace("torch.", ""), causal=causal)
            if dtype == torch.bfloat16:
                within_witness(line, q, k, v, want, causal)
            emit(line)
    # qwen3-4b's shape, timed (32 query heads over 8 KV heads, d = 128),
    # and smollm-360m's, held only (15 over 5: GQA group 3, an odd head
    # count), in the model's (B, S, H, D) storage
    for hq, hkv, d, timed in ((32, 8, 128, True), (15, 5, 64, False)):
        b, s = LM_BATCH, LM_PROMPT
        q = randn(b, s, hq, d, dtype=torch.bfloat16).transpose(1, 2)
        k, v = (randn(b, s, hkv, d, dtype=torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        want = KF.flash_attention_plain(q, k, v, causal=True)
        line = held(torch, "flash_attention", [b, hq, hkv, s, d],
                    KF.flash_attention(q, k, v, causal=True), want,
                    TOL_BF16_OUT, dtype="bfloat16", causal=True)
        within_witness(line, q, k, v, want, True)
        if timed:
            product = s * (s + 1) * d * b * hq
            nbytes = 2 * 2 * b * s * d * (hq + hkv)
            measure_line(
                torch, line, lambda q=q, k=k, v=v: KF.flash_attention(
                    q, k, v, causal=True),
                lambda q=q, k=k, v=v: KF.flash_attention_plain(
                    q, k, v, causal=True),
                lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 0.0, nbytes,
                bf16_flops=product, mixed_flops=product)
        del q, k, v, want
        emit(line)
    q, k, v, want = KF.lo_piece_probe("cuda")
    line = held(torch, "flash_attention lo-piece probe", [1, 1, 64, 16],
                KF.flash_attention(q, k, v, causal=False)[0, 0, :, 0], want,
                TOL_LO_PROBE, dtype="bfloat16", causal=False)
    # the same column from two pieces of P: the probe must see the third
    two = rel_gap(torch, KF.flash_attention_split_plain(
        q, k, v, causal=False, pieces=2)[0, 0, :, 0], want)
    line["two_pieces_rel_err"] = two
    check(two > TOL_LO_PROBE,
          f"lo-piece probe: two pieces of P read {two} <= {TOL_LO_PROBE}, so "
          f"the probe cannot see the third")
    emit(line)

    # -- ssd_scan: the served shape (B * H = 4 * 80 series), mamba2-2.7b's
    #    state N = 128 at the same batch and prompt, then f32 and a ragged
    #    last chunk; the final state is held in every case
    def ssd_inputs(bh, length, p, n, dtype):
        return (randn(bh, length, p, dtype=dtype),
                randn(bh, length, n, dtype=dtype, scale=0.5),
                randn(bh, length, n, dtype=dtype, scale=0.5),
                -0.1 * randn(bh, length).abs())

    for bh, length, n, dtype, main in (
            (LM_BATCH * 80, LM_PROMPT, 64, torch.bfloat16, True),
            (LM_BATCH * 80, LM_PROMPT, 128, torch.bfloat16, False),
            (LM_BATCH * 80, LM_PROMPT, 64, torch.float32, False),
            (8, 1000, 64, torch.float32, False)):
        p, chunk = 64, 128
        bf16 = dtype == torch.bfloat16
        args = ssd_inputs(bh, length, p, n, dtype)
        kern = lambda a=args: KS.ssd_scan(*a, chunk=chunk, return_state=True)
        plain = lambda a=args: KS.ssd_scan_plain(*a, chunk=chunk,
                                                 return_state=True)
        (y, st), (y0, st0) = kern(), plain()
        line = held(torch, "ssd_scan", [bh, length, p, n], y, y0,
                    TOL_BF16_OUT if bf16 else TOL_F32,
                    dtype=str(dtype).replace("torch.", ""), chunk=chunk)
        st_line = held(torch, "ssd_scan final state", [bh, n, p], st, st0,
                       TOL_F32)
        line["state_rel_err"] = st_line["rel_err"]
        y2, st2 = kern()
        check(torch.equal(y2, y) and torch.equal(st2, st),
              f"ssd_scan {line['shape']} {line['dtype']}: a second call "
              f"differs")
        line["repeats_bitwise"] = True
        del y2, st2
        if bf16:
            # The f32 contract, where it can be seen: the plain version
            # with its three f32 operands rounded to bf16 (the witness).
            # At N = 128 this is what holds ssd_chunk_kernel<4,8>, the
            # instantiation the mamba2-2.7b path runs.
            witness = rel_gap(torch, KS.ssd_scan_split_plain(
                *args, chunk=chunk, pieces=1), y0)
            line["witness_bf16_operands_vs_plain"] = witness
            check(line["rel_err"] <= WITNESS_SHARE * witness,
                  f"ssd_scan bf16 {line['shape']}: kernel vs plain "
                  f"{line['rel_err']} > {WITNESS_SHARE} x the bf16-operand "
                  f"witness {witness}")
        if bf16:
            cb, other, nbytes = ssd_flops_bytes(bh, length, p, n, chunk,
                                                dtype.itemsize, True)
            measure_line(torch, line, kern, plain, None, 0.0, nbytes,
                         bf16_flops=cb, mixed_flops=other)
            line["library_note"] = ("no single PyTorch call computes the SSD "
                                    "scan")
            if main:
                summary["ssd_scan"] = line
        del y, st, y0, st0
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
    from repro_torch.core.svd_grad import eigh_reg
    from repro_torch.kernels import dispatch

    prev = dispatch.set_kernel_backend(mode)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {"dtype": str(dtype).replace("torch.", ""), "mode": mode}
        widened = eigh_reg.widened
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
                   eigh_widened=eigh_reg.widened - widened,
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
    from repro_torch.kernels.gram import gram, gram_complex
    from repro_torch.kernels.matvec import tall_apply, tall_apply_complex
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.kernels import zipup_block as Z

    rng = np.random.default_rng(SEED)
    thetas = rng.uniform(0.0, THETA_MAX, size=(LAYERS, GRID * GRID))
    bits_list = likely_bitstrings(np, thetas, GRID, N_AMPLITUDES)

    # the kernel run: every count starts at 0 and is read right after
    dispatch.reset_dispatch_stats()
    for fn in (gram, gram_complex, tall_apply, tall_apply_complex,
               tiled_matmul):
        fn.launches = 0
    Z.reset_kernel_launches()
    kern, state = run_main_path(torch, torch.complex64, "kernel", thetas,
                                bits_list)
    counters = dispatch.dispatch_stats()
    launches = {"gram": gram.launches, "gram_complex": gram_complex.launches,
                "tall_apply": tall_apply.launches,
                "tall_apply_complex": tall_apply_complex.launches,
                "tiled_matmul": tiled_matmul.launches,
                **Z.kernel_launches()}

    dense, _ = run_main_path(torch, torch.complex64, "dense", thetas, bits_list)
    anchor, anchor_state = run_main_path(torch, torch.complex128, "dense",
                                         thetas, bits_list, amplitudes=False)
    # for the robustness phase's mixed-precision norm of the same state
    main = {"c128_state": anchor_state, "norm_c128_dense": anchor["norm"],
            "norm_c64_kernel": kern["norm"], "norm_c128_s": anchor["norm_s"],
            "norm_c64_kernel_s": kern["norm_s"]}
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
    # complex64 throughout: every Gram is one gram_complex launch and every
    # tall-apply one tall_apply_complex launch, so the real kernels (the
    # planar forms' parts) never run; each zip-up site call is one launch of
    # its own kernel and none of the tall-apply
    for name in ("gram_complex", "tall_apply_complex", "zipup_pair",
                 "zipup_chain"):
        check(launches[name] > 0,
              f"kernel {name} was never launched on the main path")
    check(launches["zipup_pair"]
          == counters["kernel_zipup_first_onelayer_calls"]
          + counters["kernel_pair_merge_calls"]
          and launches["zipup_chain"]
          == counters["kernel_zipup_first_twolayer_calls"]
          and launches["tall_apply_complex"]
          == counters["kernel_tall_apply_calls"],
          f"launches {launches} against site calls {counters}")
    for name in ("gram", "tall_apply", "tiled_matmul"):
        check(launches[name] == 0,
              f"kernel {name} ran {launches[name]} times on the c64 main path")
    return launches, state, main


def phase_profile(torch, state):
    """Device time by kernel for one c64 kernel-mode norm of the main-path
    state (torch.profiler), and the device's busy share of the wall time.
    Runs after the main path's counts were read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.bmps import BMPS, norm_squared
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z

    option = BMPS.randomized(CHI, niter=4, oversample=8)
    prev = dispatch.set_kernel_backend("kernel")
    try:
        norm_squared(state, option)
        torch.cuda.synchronize()
        gram_complex.launches = tall_apply_complex.launches = 0
        Z.reset_kernel_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            norm_squared(state, option)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dispatch.set_kernel_backend(prev)
    emit({"phase": "profile", "what": "norm_squared, complex64, kernel mode",
          "launches_per_norm": {
              "gram_complex": gram_complex.launches,
              "tall_apply_complex": tall_apply_complex.launches,
              **Z.kernel_launches()},
          **device_profile(prof, wall, focus=("zipup",))})


def device_profile(prof, wall: float, focus=()):
    """Device time by kernel from a torch.profiler run over ``wall``
    seconds, and the device's busy share of that wall time; every kernel
    whose name holds one of the ``focus`` words is listed as well."""
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
    def row(us, k, c):
        return {"name": k[:100], "calls": c, "device_ms": us / 1e3}

    out = {"wall_s": wall, "device_s": device_s,
           "device_busy_share": device_s / wall if wall > 0 else None,
           "top": [row(*r) for r in rows[:15]]}
    if focus:
        out["focus"] = [row(*r) for r in rows if any(w in r[1] for w in focus)]
    return out


# ---------------------------------------------------------------------------
# Imaginary time evolution (paper Section VI-D1)
# ---------------------------------------------------------------------------

def operand_layout(torch, x):
    """What a kernel form's code path depends on in one argument: a
    tensor's dtype, shape, strides and conj bit, else its value."""
    if torch.is_tensor(x):
        return (str(x.dtype).replace("torch.", ""), tuple(x.shape), x.stride(),
                x.is_conj())
    return repr(x)


@contextlib.contextmanager
def captured_site_calls(torch, sites):
    """Record, for each dispatch site in ``sites``, the arguments of the
    first call of every distinct operand layout that reaches its kernel
    form, keyed by site and layout; the sites are restored on exit."""
    from repro_torch.kernels import dispatch

    calls = {name: {} for name in sites}
    saved = {name: dispatch.site(name) for name in sites}

    def recording(name, kernel_fn):
        def kernel(*args, **kwargs):
            key = tuple(operand_layout(torch, a) for a in args) + tuple(
                (k, operand_layout(torch, v)) for k, v in sorted(kwargs.items()))
            calls[name].setdefault(key, (args, kwargs))
            return kernel_fn(*args, **kwargs)
        return kernel

    for name, s in saved.items():
        dispatch.register_kernel(name, kernel=recording(name, s.kernel_fn),
                                 dense=s.dense_fn, supported=s.supported,
                                 auto=s.auto)
    try:
        yield calls
    finally:
        for name, s in saved.items():
            dispatch.register_kernel(name, kernel=s.kernel_fn,
                                     dense=s.dense_fn, supported=s.supported,
                                     auto=s.auto)


def hold_site_calls(torch, calls):
    """Each recorded call's kernel form on the card (gram_complex and
    tall_apply_complex launches) against the same form on CPU copies of its
    arguments, where the wrappers run their plain versions.  The gap is
    taken relative to the same form on the operands' magnitudes (|A| |B|
    for a product, |A|^T |A| for a Gram), the scale of f32 rounding in a
    product: held at TOL_F32.  Relative to the result itself it is printed
    only, as the Gram-QR projections of rank-deficient operands cancel
    (on the H100 a J1-J2 projection reads 1.33e-5 of the result, 8.9e-8
    of |A| |B|).
    Returns per site the number of distinct layouts, the largest gaps and
    the layouts of the worst call."""
    from repro_torch.kernels import dispatch

    def cpu(x, magnitude=False):
        if not torch.is_tensor(x):
            return x
        return x.abs().cpu() if magnitude else x.cpu()

    out = {}
    for name, seen in calls.items():
        kernel_fn = dispatch.site(name).kernel_fn
        errs, rels = [], []
        for key, (args, kwargs) in seen.items():
            got = kernel_fn(*args, **kwargs).cpu()
            want = kernel_fn(*(cpu(a) for a in args), **kwargs)
            scale = torch.linalg.norm(
                kernel_fn(*(cpu(a, True) for a in args), **kwargs)).item()
            gap = torch.linalg.norm(got - want).item()
            errs.append((gap / (scale or 1.0), key))
            rels.append(gap / (torch.linalg.norm(want).item() or 1.0))
        worst, worst_key = max(
            errs, key=lambda e: e[0] if math.isfinite(e[0]) else math.inf,
            default=(0.0, None))
        out[name] = {"layouts": len(seen), "max_err_of_magnitudes": worst,
                     "max_rel_err": max(rels, default=0.0),
                     "worst": repr(worst_key)}
        check(len(seen) > 0, f"site {name} never reached its kernel form")
        check(math.isfinite(worst) and worst <= TOL_F32,
              f"{name} kernel form vs plain on an ITE operand: {out[name]}")
    return out


def ite_run_line(torch, label, obs, update, contract, steps, dtype, mode,
                 e_ref, split_first=False, bits=None):
    """One ``ite_run`` from |bits> (|0...0> by default) on the ITE grid,
    timed, with the two PEPS kernels' launches counted from 0.
    ``split_first`` runs one step, then the rest from its state (the
    reference's acceptance test), so that the planner counters of the
    second run are those after step 1.  In kernel mode the operands that
    reach the kernels are recorded and then held against the plain
    versions (``operands`` in the line)."""
    from repro_torch.core.ite import ite_run
    from repro_torch.core.peps import computational_basis
    from repro_torch.core.svd_grad import eigh_reg
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z

    if bits is None:
        bits = [[0] * ITE_GRID] * ITE_GRID
    capture = (captured_site_calls(torch, ITE_SITES) if mode == "kernel"
               else contextlib.nullcontext())
    prev = dispatch.set_kernel_backend(mode)
    try:
        with capture as calls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gram_complex.launches = tall_apply_complex.launches = 0
            Z.reset_kernel_launches()
            widened = eigh_reg.widened
            t0 = time.perf_counter()
            state = computational_basis(bits, dtype=dtype)
            first = None
            if split_first:
                first = ite_run(state, obs, ITE_TAU, 1, update, contract)
                state = first.state
            rest = steps - bool(first)
            res = ite_run(state, obs, ITE_TAU, rest, update, contract,
                          measure_every=rest)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"gram_complex": gram_complex.launches,
                        "tall_apply_complex": tall_apply_complex.launches,
                        **Z.kernel_launches()}
            widened = eigh_reg.widened - widened
            peak = torch.cuda.max_memory_allocated()
        # after the counts were read: these launches do not count
        operands = hold_site_calls(torch, calls) if calls else None
    finally:
        dispatch.set_kernel_backend(prev)
    st = res.planner_stats
    hit = lambda k: st[f"{k}_hits"] / max(st[f"{k}_hits"] + st[f"{k}_misses"], 1)
    fids = (first.fidelities if first else []) + (res.fidelities or [])
    nan = any(math.isnan(f) for f in fids)
    energy = res.energies[-1]
    line = {"phase": "ite", "run": label,
            "dtype": str(dtype).replace("torch.", ""), "mode": mode,
            "update": {k: v for k, v in vars(update).items()
                       if isinstance(v, (int, float, bool))},
            "steps": steps, "wall_s": wall, "s_per_step": wall / steps,
            "energy": energy, "e_ref": e_ref,
            "rel_err_vs_ref": abs(energy - e_ref) / abs(e_ref),
            "min_fidelity": math.nan if nan else min(fids, default=None),
            "max_fidelity": math.nan if nan else max(fids, default=None),
            "planner": {"path_hit_rate": hit("path"),
                        "fused_hit_rate": hit("fused"),
                        "path_misses": st["path_misses"],
                        "fused_misses": st["fused_misses"],
                        "after_step_1": split_first},
            "launches": launches, "operands": operands,
            "max_bond": res.state.max_bond(), "eigh_widened": widened,
            "max_memory_allocated": peak}
    emit(line)
    return line, res.state


def profile_trotter_step(torch, label, state, obs, update):
    """Device time by kernel of one c64 kernel-mode Trotter step of
    ``ite.trotter_step`` (the step ``ite_run`` takes) under torch.profiler,
    after one unprofiled step whose environments it carries on, with the
    kernels' counts."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.ite import trotter_moments, trotter_step
    from repro_torch.core.keys import TorchKey
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z

    moments = trotter_moments(obs, ITE_TAU)
    prev = dispatch.set_kernel_backend("kernel")
    try:
        state, key, envs, since = trotter_step(state, moments, update,
                                               TorchKey(SEED))
        torch.cuda.synchronize()
        gram_complex.launches = tall_apply_complex.launches = 0
        Z.reset_kernel_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trotter_step(state, moments, update, key, envs, since)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dispatch.set_kernel_backend(prev)
    emit({"phase": "ite_profile", "what": label,
          "launches_per_step": {
              "gram_complex": gram_complex.launches,
              "tall_apply_complex": tall_apply_complex.launches,
              **Z.kernel_launches()},
          **device_profile(prof, wall, focus=("gram_tile", "gram_reduce",
                                              "tall_apply_kernel",
                                              "zipup"))})


def phase_ite(torch, np):
    """Trotterized ITE on 4x4 grids, the repository's own configurations:
    the full-update acceptance run (TFI, tests/test_full_update.py and
    benchmarks/bench_full_update.py) against the QR update and the exact
    statevector ITE, and the J1-J2 model of paper Fig. 13 with the QR
    update from the Neel state against its statevector ITE.  The complex64
    runs go through the Gram and tall-apply kernels (forced ``kernel``
    mode: at these sizes ``auto`` keeps every Gram dense) and are held to
    the complex128 runs of the same configuration, and J1-J2's to its
    complex64 dense run.  Returns the kernels' launches over the c64
    kernel-mode runs."""
    import dataclasses
    from repro_torch.core.bmps import BMPS
    from repro_torch.core.einsumsvd import RandomizedSVD
    from repro_torch.core.ite import ite_statevector
    from repro_torch.core.observable import j1j2_hamiltonian, tfi_hamiltonian
    from repro_torch.core.peps import FullUpdate, QRUpdate

    t_phase = time.perf_counter()
    tfi = tfi_hamiltonian(ITE_GRID, ITE_GRID, jz=-1.0, hx=-3.5)
    t0 = time.perf_counter()
    _, e_ref = ite_statevector(ITE_GRID, ITE_GRID, tfi, ITE_TAU,
                               ITE_REF_STEPS)
    emit({"phase": "ite", "run": "statevector", "model": "tfi",
          "steps": ITE_REF_STEPS, "energy": e_ref,
          "wall_s": time.perf_counter() - t0})
    measure = BMPS(ITE_MEASURE_CHI)
    fu = FullUpdate(rank=ITE_RANK, chi=ITE_ENV_CHI, env_refresh_every=40)
    qr, _ = ite_run_line(torch, "tfi_qr", tfi, QRUpdate(rank=ITE_RANK),
                         measure, ITE_STEPS, torch.complex128, "dense", e_ref)
    fu128, _ = ite_run_line(torch, "tfi_fu", tfi, fu, measure, ITE_STEPS,
                            torch.complex128, "dense", e_ref, split_first=True)
    # complex64 with the reference's defaults first: its ALS regulariser
    # als_eps = 1e-12 lies far below complex64 rounding
    try:
        fu64, state64 = ite_run_line(torch, "tfi_fu_defaults", tfi, fu,
                                     measure, ITE_STEPS, torch.complex64,
                                     "kernel", e_ref, split_first=True)
        held_fu = fu if math.isfinite(fu64["energy"]) else None
    except torch.linalg.LinAlgError as e:
        emit({"phase": "ite", "run": "tfi_fu_defaults", "dtype": "complex64",
              "als_eps": fu.als_eps, "error": str(e)[:300]})
        held_fu = None
    if held_fu is None:
        held_fu = dataclasses.replace(fu, als_eps=C64_ALS_EPS)
        fu64, state64 = ite_run_line(torch, "tfi_fu_als_eps", tfi, held_fu,
                                     measure, ITE_STEPS, torch.complex64,
                                     "kernel", e_ref, split_first=True)

    j1j2 = j1j2_hamiltonian(ITE_GRID, ITE_GRID)
    neel = np.indices((ITE_GRID, ITE_GRID)).sum(axis=0) % 2
    t0 = time.perf_counter()
    _, e_j1j2 = ite_statevector(ITE_GRID, ITE_GRID, j1j2, ITE_TAU, J1J2_STEPS,
                                bits=neel)
    emit({"phase": "ite", "run": "statevector", "model": "j1j2",
          "start": "neel", "terms": len(j1j2), "steps": J1J2_STEPS,
          "energy": e_j1j2, "wall_s": time.perf_counter() - t0})
    j_measure = BMPS(ITE_MEASURE_CHI, RandomizedSVD(niter=2, oversample=4))
    j_update = QRUpdate(rank=J1J2_RANK)
    j_runs = {}
    for name, dtype, mode in (("c128", torch.complex128, "dense"),
                              ("c64_dense", torch.complex64, "dense"),
                              ("c64_kernel", torch.complex64, "kernel")):
        j_runs[name], jstate = ite_run_line(
            torch, "j1j2_qr", j1j2, j_update, j_measure, J1J2_STEPS, dtype,
            mode, e_j1j2, bits=neel)
    j64 = j_runs["c64_kernel"]

    def gap(lo, hi):
        return abs(lo["energy"] - hi["energy"]) / abs(hi["energy"])

    errs = {"err_qr": abs(qr["energy"] - e_ref),
            "err_fu": abs(fu128["energy"] - e_ref),
            "tfi_fu_c64_vs_c128": gap(fu64, fu128),
            "j1j2_c64_vs_c128": gap(j64, j_runs["c128"]),
            "j1j2_c64_dense_vs_c128": gap(j_runs["c64_dense"], j_runs["c128"]),
            "j1j2_c64_kernel_vs_dense": gap(j64, j_runs["c64_dense"]),
            **{f"j1j2_{k}_vs_statevector": run["rel_err_vs_ref"]
               for k, run in j_runs.items()}}
    c64_runs = {"tfi_fu": fu64, "j1j2_qr": j64}
    launches = {k: sum(run["launches"][k] for run in c64_runs.values())
                for k in fu64["launches"]}
    bounds = {"tfi_fu_c64_vs_c128": TOL_ITE_C64,
              "j1j2_c64_vs_c128": TOL_ITE_C64,
              "j1j2_c64_dense_vs_c128": TOL_ITE_C64,
              "j1j2_c64_kernel_vs_dense": TOL_ITE_C64,
              **{f"j1j2_{k}_vs_statevector": J1J2_SV_TOL for k in j_runs}}
    emit({"phase": "ite", "errors": errs, "launches": launches,
          "bounds": bounds, "seconds": time.perf_counter() - t_phase})
    check(errs["err_fu"] < errs["err_qr"], f"full update not below QR: {errs}")
    check(errs["err_fu"] < ITE_FU_TOL * abs(e_ref),
          f"full update off the statevector ITE: {errs}")
    for run in (fu128, fu64):
        check(0.9 <= run["min_fidelity"] and run["max_fidelity"] <= 1 + 1e-9,
              f"fidelity out of [0.9, 1]: {run}")
    for k, bound in bounds.items():
        check(errs[k] <= bound, f"{k} {errs[k]} > {bound}: {errs}")
    for name, run in c64_runs.items():
        for k in TWO_LAYER_KERNELS:
            check(run["launches"][k] > 0,
                  f"{k} never launched in the c64 {name} run")

    profile_trotter_step(torch, "full update, 4x4 TFI, D=3, chi=12, c64",
                         state64, tfi, held_fu)
    profile_trotter_step(torch, "QR update, 4x4 J1-J2, D=4, c64", jstate,
                         j1j2, j_update)
    return launches


# ---------------------------------------------------------------------------
# Serving the LM families through the LM kernels
# ---------------------------------------------------------------------------

def logits_gap(torch, got, want):
    """(relative Frobenius gap, allclose excess): the excess is
    max(|got - want| - (atol + rtol |want|)) at rtol = atol = TOL_DECODE,
    <= 0 when ``np.testing.assert_allclose`` would pass."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    gap = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
    excess = (diff - TOL_DECODE * (1 + want.abs())).max().item()
    return gap, excess


def prefill_in(torch, T, mode, params, cfg, tokens, max_seq,
               cache_dtype=None):
    """One prefill with every site in ``mode``; (logits, cache, seconds).
    The cache is bf16 unless ``cache_dtype`` says otherwise."""
    from repro_torch.kernels import dispatch
    prev = dispatch.set_kernel_backend(mode)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, tokens, max_seq,
                                  cache_dtype=cache_dtype or torch.bfloat16)
        torch.cuda.synchronize()
        return logits, cache, time.perf_counter() - t0
    finally:
        dispatch.set_kernel_backend(prev)


def served_launches(cfg):
    """The kernels' launches in one prefill of ``cfg``'s stack: one
    ``flash_attention`` per attention layer, one ``ssd_scan`` per Mamba2
    layer (decode launches neither)."""
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_group
        return {"flash_attention": n_groups,
                "ssd_scan": n_groups * (cfg.hybrid_group - 1)}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "ssd_scan": cfg.n_layers}
    return {"flash_attention": cfg.n_layers, "ssd_scan": 0}


def phase_lm_serve(torch, np, arch):
    """``arch`` at full width and depth with bf16 weights drawn on the card
    from SEED: prefill 4 x 2,048 tokens through the kernels, decode 64
    greedy tokens, and check (a) finite logits, (b) kernel vs plain prefill
    logits and (c) prefill + decode against the longer prefill, each in
    bf16 and on the same weights in f32.  The bf16 bounds come from the
    measured distance of the plain bf16 prefill from the plain f32 one.
    Returns the kernels' launch counts of the served prefill and decode."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import fits, ssd_scan
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build

    t_phase = time.perf_counter()
    cfg = get(arch)
    per_prefill = served_launches(cfg)
    bundle = build(cfg)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(LM_BATCH, LM_PROMPT))).cuda()
    max_seq = LM_PROMPT + LM_DECODE
    out = {"phase": "lm_serve", "arch": arch, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "decode_tokens": LM_DECODE}
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = bundle.init(SEED)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["param_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in tree_leaves(params))
        # the draw's f32 temporaries peak above what serving holds: the
        # served peak (weights, cache, activations) is read from here on
        out["init_max_memory_allocated"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        # the served run: every count starts at 0 and is read right after
        dispatch.reset_dispatch_stats()
        flash_attention.launches = 0
        ssd_scan.launches = 0
        logits, cache, out["prefill_s"] = prefill_in(
            torch, T, "kernel", params, cfg, tokens, max_seq)
        prefill_launches = {"flash_attention": flash_attention.launches,
                            "ssd_scan": ssd_scan.launches}
        finite = torch.isfinite(logits).all()
        tok = logits.argmax(dim=-1, keepdim=True)
        generated = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LM_DECODE):
            step_logits, cache = bundle.serve_step(params, cache, tok)
            finite &= torch.isfinite(step_logits).all()
            tok = step_logits.argmax(dim=-1, keepdim=True)
            generated.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counters = dispatch.dispatch_stats()
        launches = {"flash_attention": flash_attention.launches,
                    "ssd_scan": ssd_scan.launches}
        out.update(
            decode_ms_per_token=decode_s / LM_DECODE * 1e3,
            decode_tokens_per_s=LM_BATCH * LM_DECODE / decode_s,
            prefill_tokens_per_s=LM_BATCH * LM_PROMPT / out["prefill_s"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            prefill_launches=prefill_launches, launches=launches,
            counters={k: v for k, v in counters.items()
                      if k.endswith(("_attention_calls", "_ssd_calls"))},
            generated=torch.cat(generated, dim=1)[:, :8].tolist())
        check(bool(finite),
              f"lm_serve {arch}: non-finite logits in prefill or decode")
        check(prefill_launches == per_prefill and launches == per_prefill,
              f"lm_serve {arch}: launches per prefill {prefill_launches} "
              f"and with decode {launches}, expected {per_prefill} and none "
              f"in decode")
        check(counters["kernel_attention_calls"]
              == per_prefill["flash_attention"]
              and counters["kernel_ssd_calls"] == per_prefill["ssd_scan"]
              and counters["dense_attention_calls"] == 0
              and counters["dense_ssd_calls"] == 0,
              f"lm_serve {arch}: dispatch counters {counters}")

        # the same prefill again (warm), and through the plain versions
        logits2, _, out["prefill_warm_s"] = prefill_in(
            torch, T, "kernel", params, cfg, tokens, max_seq)
        out["prefill_repeats_bitwise"] = bool(torch.equal(logits, logits2))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = prefill_in(torch, T, "kernel", params, cfg, tokens,
                                    max_seq)
        prof_line = {"phase": "lm_profile", "arch": arch,
                     "what": f"one kernel-mode prefill, {LM_BATCH} x "
                     f"{LM_PROMPT} tokens, bf16",
                     **device_profile(prof, wall, focus=("ssd_", "flash_"))}
        for word in ("ssd_", "flash_"):
            prof_line[f"{word}device_ms"] = sum(
                r["device_ms"] for r in prof_line["focus"] if word in r["name"])
        emit(prof_line)
        for kernel, name in ((SSD_BF16_KERNEL, "ssd_scan"),
                             (FLASH_BF16_KERNEL, "flash_attention")):
            calls = sum(r["calls"] for r in prof_line["focus"]
                        if kernel in r["name"])
            check(calls == per_prefill[name],
                  f"lm_profile {arch}: {kernel} ran {calls} times in a "
                  f"prefill, not {per_prefill[name]}")
        step_cache = {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in cache.items()}
        step_cache["index"] = LM_PROMPT
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bundle.serve_step(params, step_cache, tokens[:, -1:])
            torch.cuda.synchronize()
        emit({"phase": "lm_profile", "arch": arch, "what": f"one decode "
              f"step, batch {LM_BATCH}, bf16", **device_profile(
                  prof, time.perf_counter() - t0)})
        del step_cache
        dense, _, out["prefill_dense_s"] = prefill_in(
            torch, T, "dense", params, cfg, tokens, max_seq)
        out["bf16_kernel_vs_dense"], _ = logits_gap(torch, logits, dense)
        del logits2

        # (c) prefill t0..t2046, decode t2047, against the prefill of all
        out["bf16_decode_vs_prefill"] = decode_vs_prefill(
            torch, T, bundle, params, cfg, tokens, logits)

        # the same weights in f32 (the bf16 values, exactly): (b) and (c)
        # as rounding comparisons, and the bf16 model's rounding floor.
        # Where the f32 SSD kernel does not fit the state (mamba2's N =
        # 128), "auto" runs the SSD dense, as it does for any f32 caller:
        # then the bf16 checks hold the SSD kernel on this path, and the
        # kernels phase holds it at the same shape against its witness.
        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                    act_dtype=torch.float32)
        f32_mode = "kernel"
        if cfg.family != "dense" and not fits(
                cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, torch.float32):
            f32_mode = "auto"
            out["f32_note"] = (
                f"the f32 SSD kernel does not fit N = {cfg.ssm_state} at "
                f"chunk {cfg.ssm_chunk}, so 'auto' runs the f32 SSD dense: "
                f"the f32 kernel-vs-plain gap holds no SSD kernel here; the "
                f"bf16 checks hold {SSD_BF16_KERNEL}, and the kernels phase "
                f"holds it at this shape within {WITNESS_SHARE} of the "
                f"bf16-operand witness")
        out["f32_mode"] = f32_mode
        params32 = as_f32(params)
        del params, cache
        torch.cuda.empty_cache()
        dispatch.reset_dispatch_stats()
        kern32, kcache, out["f32_prefill_s"] = prefill_in(
            torch, T, f32_mode, params32, cfg32, tokens, LM_PROMPT,
            torch.float32)
        out["f32_counters"] = {
            k: v for k, v in dispatch.dispatch_stats().items()
            if k.endswith(("_attention_calls", "_ssd_calls"))}
        dense32, dcache, out["f32_prefill_dense_s"] = prefill_in(
            torch, T, "dense", params32, cfg32, tokens, LM_PROMPT,
            torch.float32)
        out["f32_kernel_vs_dense"], _ = logits_gap(torch, kern32, dense32)
        out["f32_cache_kernel_vs_dense"] = {
            key: logits_gap(torch, kcache[key], dcache[key])[0]
            for key in kcache if key != "index"}
        del kcache, dcache
        out["bf16_floor"], _ = logits_gap(torch, dense, dense32)
        out["bf16_kernel_vs_f32"], _ = logits_gap(torch, logits, dense32)
        out["f32_decode_vs_prefill"] = decode_vs_prefill(
            torch, T, build(cfg32), params32, cfg32, tokens, kern32,
            torch.float32, f32_mode)
        del params32
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    bf16_tol = LM_BF16_FLOORS * out["bf16_floor"]
    check(out["bf16_floor"] <= TOL_LM_BF16_FLOOR,
          f"lm_serve {arch}: bf16 plain vs f32 plain logits "
          f"{out['bf16_floor']}")
    check(out["f32_kernel_vs_dense"] <= TOL_LM_F32,
          f"lm_serve {arch}: f32 kernel vs plain logits "
          f"{out['f32_kernel_vs_dense']}")
    check(out["bf16_kernel_vs_dense"] <= bf16_tol,
          f"lm_serve {arch}: bf16 kernel vs plain logits "
          f"{out['bf16_kernel_vs_dense']} > {bf16_tol}")
    check(out["f32_decode_vs_prefill"]["allclose_excess"] <= 0,
          f"lm_serve {arch}: f32 prefill + decode vs prefill "
          f"{out['f32_decode_vs_prefill']}")
    check(out["bf16_decode_vs_prefill"]["rel"] <= bf16_tol,
          f"lm_serve {arch}: bf16 prefill + decode vs prefill "
          f"{out['bf16_decode_vs_prefill']} > {bf16_tol}")
    return launches


def as_f32(tree):
    """A parameter tree with every leaf in f32."""
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    return tree.float()


def decode_vs_prefill(torch, T, bundle, params, cfg, tokens, want,
                      cache_dtype=None, mode="kernel"):
    """Check (c): prefill all but the last token (sites in ``mode``),
    decode the last one, and compare with ``want``, the logits of the
    prefill of all the tokens."""
    _, cache, _ = prefill_in(torch, T, mode, params, cfg, tokens[:, :-1],
                             tokens.shape[1], cache_dtype)
    got, _ = bundle.serve_step(params, cache, tokens[:, -1:])
    rel_gap, excess = logits_gap(torch, got, want)
    return {"rel": rel_gap, "allclose_excess": excess}


# ---------------------------------------------------------------------------
# VQE: gradients through the regularized factorizations (paper Section VI-D2)
# ---------------------------------------------------------------------------

def vqe_kernel_energies(torch, np, obs, thetas, budgets):
    """c64 energies in forced ``kernel`` mode under ``torch.no_grad()`` at
    each ``(rank, chi)`` of ``budgets``, with the two PEPS kernels'
    launches counted from 0; each distinct operand layout that reached
    them is then held against the plain versions."""
    from repro_torch.core.bmps import BMPS
    from repro_torch.core.peps import QRUpdate
    from repro_torch.core.vqe import vqe_energy_peps
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z

    prev = dispatch.set_kernel_backend("kernel")
    try:
        with captured_site_calls(torch, VQE_SITES) as calls:
            gram_complex.launches = tall_apply_complex.launches = 0
            Z.reset_kernel_launches()
            with torch.no_grad():
                energies = [float(vqe_energy_peps(
                    thetas, VQE_GRID, VQE_GRID, obs, QRUpdate(rank=rank),
                    BMPS(chi), dtype=torch.complex64))
                    for rank, chi in budgets]
            launches = {"gram_complex": gram_complex.launches,
                        "tall_apply_complex": tall_apply_complex.launches,
                        **Z.kernel_launches()}
        # after the counts were read: these launches do not count
        operands = hold_site_calls(torch, calls)
    finally:
        dispatch.set_kernel_backend(prev)
    return energies, launches, operands


def phase_vqe(torch, np):
    """VQE on the paper's Fig. 14 setting at full width: the c128
    value-and-grad against central differences and the statevector
    gradient, c64 energies through the kernels and the c64 gradient
    (dense, as the kernels have no backward) against c128, the forced
    kernel mode refusing a differentiated operand, the three optimizers
    at the bench's budget, and one profiled value-and-grad step.
    Returns the kernels' launches over the c64 kernel-mode energies and
    the phase's headline numbers (repeated on the ``done`` line)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.bmps import BMPS
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.core.peps import QRUpdate
    from repro_torch.core.svd_grad import eigh_reg
    from repro_torch.core.vqe import (run_vqe, vqe_energy_and_grad,
                                      vqe_energy_peps, vqe_energy_statevector)
    from repro_torch.kernels import dispatch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    widened = eigh_reg.widened
    obs = tfi_hamiltonian(VQE_GRID, VQE_GRID, jz=-1.0, hx=-3.5)
    n_params = VQE_LAYERS * VQE_GRID * VQE_GRID
    rng = np.random.default_rng(SEED + 2)
    thetas = rng.uniform(-np.pi, np.pi, n_params)
    update, contract = QRUpdate(rank=VQE_RANK), BMPS(VQE_CHI)

    def value_and_grad(dtype=torch.complex128, **kw):
        e, g = vqe_energy_and_grad(thetas, VQE_GRID, VQE_GRID, obs,
                                   kw.get("update", update),
                                   kw.get("contract", contract), dtype=dtype)
        return float(e), g.cpu().numpy()

    # c128: the first call, then timed calls
    t0 = time.perf_counter()
    e128, g128 = value_and_grad()
    first_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        value_and_grad()
    torch.cuda.synchronize()
    grad_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    with torch.no_grad():
        energy_only = float(vqe_energy_peps(thetas, VQE_GRID, VQE_GRID, obs,
                                            update, contract))
    torch.cuda.synchronize()
    energy_s = time.perf_counter() - t0

    # central differences on VQE_FD_COMPONENTS components
    comps = [int(i) for i in rng.choice(n_params, VQE_FD_COMPONENTS,
                                        replace=False)]
    fd_errs = {}
    for i in comps:
        d = np.zeros(n_params)
        d[i] = VQE_FD_STEP
        with torch.no_grad():
            hi, lo = (float(vqe_energy_peps(thetas + sgn * d, VQE_GRID,
                                            VQE_GRID, obs, update, contract))
                      for sgn in (1.0, -1.0))
        fd = (hi - lo) / (2 * VQE_FD_STEP)
        fd_errs[i] = abs(g128[i] - fd) / max(abs(fd), 1e-8)

    # the statevector gradient through autograd
    th = torch.tensor(thetas, dtype=torch.float64, device="cuda",
                      requires_grad=True)
    esv_t = vqe_energy_statevector(th, VQE_GRID, VQE_GRID, obs)
    (gsv,) = torch.autograd.grad(esv_t, th)
    esv, gsv = esv_t.item(), gsv.cpu().numpy()
    sv_errs = {"energy": abs(e128 - esv),
               "grad_max_abs": float(np.max(np.abs(g128 - gsv)))}

    # complex64: energies through the kernels, the gradient dense
    budgets = [(VQE_RANK, VQE_CHI), (VQE_OPT_RANK, VQE_OPT_CHI)]
    with torch.no_grad():
        e128_opt = float(vqe_energy_peps(thetas, VQE_GRID, VQE_GRID, obs,
                                         QRUpdate(rank=VQE_OPT_RANK),
                                         BMPS(VQE_OPT_CHI)))
        dense64 = [float(vqe_energy_peps(
            thetas, VQE_GRID, VQE_GRID, obs, QRUpdate(rank=r), BMPS(c),
            dtype=torch.complex64)) for r, c in budgets]
    kernel64, launches, operands = vqe_kernel_energies(torch, np, obs,
                                                       thetas, budgets)
    refs = [e128, e128_opt]
    dispatch.reset_dispatch_stats()
    t0 = time.perf_counter()
    e64, g64 = value_and_grad(torch.complex64)
    grad64_s = time.perf_counter() - t0
    stats = dispatch.dispatch_stats()
    grad_routing = {k: v for k, v in stats.items()
                    if v and k.split("_")[0] in ("kernel", "dense")}
    c64 = {"energy_kernel_vs_c128": [abs(k - r) / abs(r)
                                     for k, r in zip(kernel64, refs)],
           "energy_dense_vs_c128": [abs(d - r) / abs(r)
                                    for d, r in zip(dense64, refs)],
           "energy_kernel_vs_dense": [abs(k - d) / abs(d)
                                      for k, d in zip(kernel64, dense64)],
           "grad_vs_c128": float(np.max(np.abs(g64 - g128))
                                 / np.max(np.abs(g128))),
           "grad_energy_vs_c128": abs(e64 - e128) / abs(e128)}

    # forced kernel mode refuses a differentiated operand
    prev = dispatch.set_kernel_backend("kernel")
    refused = None
    try:
        value_and_grad(torch.complex64)
    except RuntimeError as e:
        refused = str(e)[:200]
    finally:
        dispatch.set_kernel_backend(prev)

    # the optimizers at the bench's budget
    opts = {}
    for name, kw, steps in (
            ("adam", dict(method="adam", ensemble=VQE_OPT_ENSEMBLE),
             VQE_OPT_STEPS),
            ("spsa", dict(method="spsa", ensemble=VQE_OPT_ENSEMBLE),
             VQE_OPT_STEPS),
            ("slsqp", dict(method="SLSQP"), VQE_SLSQP_ITERS)):
        t0 = time.perf_counter()
        res = run_vqe(VQE_GRID, VQE_GRID, obs, VQE_LAYERS, VQE_OPT_RANK,
                      contract_bond=VQE_OPT_CHI, maxiter=steps, seed=SEED,
                      **kw)
        wall = time.perf_counter() - t0
        opts[name] = {"steps": steps, "wall_s": wall,
                      "s_per_step": wall / steps, "n_evals": res.n_evals,
                      "energy": res.energy, "history": res.history}

    # one profiled value-and-grad step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        value_and_grad()
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    profiled = device_profile(prof, prof_wall)
    profiled["busy_share_of_unprofiled_step"] = profiled["device_s"] / grad_s

    line = {"phase": "vqe", "model": "tfi 3x3, jz=-1, hx=-3.5",
            "layers": VQE_LAYERS, "params": n_params,
            "rank": VQE_RANK, "chi": VQE_CHI,
            "c128": {"energy": e128, "energy_no_grad": energy_only,
                     "first_value_and_grad_s": first_s,
                     "s_per_value_and_grad": grad_s, "s_per_energy": energy_s,
                     "fd_components": comps,
                     "fd_rel_err": {str(k): v for k, v in fd_errs.items()},
                     "statevector_energy": esv, "vs_statevector": sv_errs},
            "c64": {"energies_kernel": kernel64, "energies_dense": dense64,
                    "budgets": budgets, **c64,
                    "s_per_value_and_grad": grad64_s,
                    "grad_routing": grad_routing},
            "launches": launches, "operands": operands,
            "forced_kernel_with_grad": refused,
            "optimizers": opts, "eigh_widened": eigh_reg.widened - widened,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    emit({"phase": "vqe_profile", "what": "value_and_grad, c128, 3x3 TFI, "
          f"rank {VQE_RANK}, chi {VQE_CHI}", **profiled})

    check(all(math.isfinite(x) for x in [e128, *g128, e64, *g64]),
          f"non-finite VQE energy or gradient: {line}")
    check(abs(energy_only - e128) <= 1e-12 * max(abs(e128), 1.0),
          f"value-and-grad energy differs from the plain energy: {line}")
    for i, err in fd_errs.items():
        check(err <= VQE_FD_RTOL, f"AD vs FD, component {i}: {fd_errs}")
    check(sv_errs["energy"] <= VQE_SV_TOL
          and sv_errs["grad_max_abs"] <= VQE_SV_GRAD_TOL,
          f"exact budget vs statevector: {sv_errs}")
    for k in ("energy_kernel_vs_c128", "energy_dense_vs_c128",
              "energy_kernel_vs_dense"):
        check(max(c64[k]) <= VQE_C64_ENERGY_TOL, f"c64 {k}: {c64}")
    check(c64["grad_energy_vs_c128"] <= VQE_C64_ENERGY_TOL
          and c64["grad_vs_c128"] <= VQE_C64_GRAD_TOL,
          f"c64 gradient vs c128: {c64}")
    check(all(v == 0 for k, v in grad_routing.items()
              if k.startswith("kernel_"))
          and grad_routing.get("dense_gram_grad_calls", 0) > 0
          and grad_routing.get("dense_tall_apply_grad_calls", 0) > 0,
          f"c64 gradient did not route dense: {grad_routing}")
    check(refused is not None and "no backward" in refused,
          f"forced kernel mode took a differentiated operand: {refused}")
    for k in TWO_LAYER_KERNELS:
        check(launches[k] > 0,
              f"{k} never launched in the c64 kernel-mode energies")
    for name, o in opts.items():
        check(all(math.isfinite(e) for e in o["history"]),
              f"{name}: non-finite energy: {o}")
    check(opts["adam"]["history"][-1] < opts["adam"]["history"][0],
          f"adam did not lower the energy: {opts['adam']}")
    check(opts["slsqp"]["energy"] <= opts["slsqp"]["history"][0],
          f"SLSQP ended above its start: {opts['slsqp']}")
    summary = {"seconds": line["seconds"], "s_per_value_and_grad": grad_s,
               "s_per_energy": energy_s, "vs_statevector": sv_errs,
               "fd_rel_err_max": max(fd_errs.values()),
               "c64_energy_max": max(max(c64[k]) for k in (
                   "energy_kernel_vs_c128", "energy_dense_vs_c128",
                   "energy_kernel_vs_dense")),
               "c64_grad_vs_c128": c64["grad_vs_c128"],
               "busy_share": profiled["busy_share_of_unprofiled_step"],
               "optimizer_wall_s": {k: o["wall_s"] for k, o in opts.items()},
               "max_memory_allocated": line["max_memory_allocated"]}
    return launches, summary


# ---------------------------------------------------------------------------
# Robustness: precision policies, the runtime guard, checkpoint/resume
# ---------------------------------------------------------------------------

def precision_cases(torch, np, dev):
    """The acceptance cases of ``ERROR_BUDGETS`` on ``dev``, each a function
    ``(precision, randomized) -> complex`` of the same inputs and key."""
    from repro_torch.core import statevector as sv
    from repro_torch.core.bmps import BMPS, amplitude, contract_onelayer, \
        norm_squared
    from repro_torch.core.circuits import apply_circuit_exact_peps, \
        apply_circuit_statevector, random_circuit
    from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD
    from repro_torch.core.ite import ite_run
    from repro_torch.core.keys import TorchKey
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.core.peps import FullUpdate, QRUpdate, \
        computational_zeros, random_onelayer
    from repro_torch.core.precision import wrap_svd
    from repro_torch.kernels import dispatch

    def option(precision, randomized):
        return (BMPS.randomized(8, precision=precision) if randomized
                else BMPS(8, precision=precision))

    def key():
        return TorchKey(ROB_KEY_SEED)

    tfi = tfi_hamiltonian(ITE_GRID, ITE_GRID, jz=-1.0, hx=-3.5)
    rows = [[t.to(dev) for t in row] for row in random_onelayer(
        ITE_GRID, ITE_GRID, 3, torch.Generator().manual_seed(42),
        device="cpu")]
    prev = dispatch.set_kernel_backend("dense")
    try:
        state44 = ite_run(computational_zeros(ITE_GRID, ITE_GRID, device=dev),
                          tfi, ITE_TAU, ROB_QR_STEPS, QRUpdate(rank=ITE_RANK),
                          BMPS(ITE_MEASURE_CHI),
                          measure_every=ROB_QR_STEPS).state
    finally:
        dispatch.set_kernel_backend(prev)
    circ = random_circuit(3, 3, 8, seed=3)
    rqc = apply_circuit_exact_peps(computational_zeros(3, 3, device=dev), circ)
    bits = np.zeros((3, 3), dtype=int)
    psi = apply_circuit_statevector(sv.zeros(9, device=dev), circ)

    def full_update_step(p, randomized):
        svd = RandomizedSVD() if randomized else DirectSVD()
        upd = FullUpdate(rank=ITE_RANK, chi=8, svd=wrap_svd(svd, p),
                         env_svd=wrap_svd(svd, p))
        return ite_run(computational_zeros(ITE_GRID, ITE_GRID, device=dev),
                       tfi, ITE_TAU, 1, upd, option(p, randomized),
                       measure_every=1, key=key()).energies[-1]

    cases = {
        "contract_onelayer": lambda p, r: complex(contract_onelayer(
            rows, option(p, r), key=key())),
        "contract_twolayer": lambda p, r: complex(norm_squared(
            state44, option(p, r), key())),
        "amplitude": lambda p, r: complex(amplitude(rqc, bits, option(p, r),
                                                    key())),
        "full_update_ite_step": full_update_step,
    }
    return cases, complex(psi[(0,) * 9])


def bf16_instantiations(prof):
    """Calls of the bf16 instantiations of the Gram and tall-apply tile
    kernels in a torch.profiler run (demangled or mangled names)."""
    patterns = {
        "gram_tile_kernel<complex,bf16>":
            r"gram_tile_kernel(<true, true>|ILb1ELb1E)",
        "tall_apply_kernel<complex,bf16,·>":
            r"tall_apply_kernel(<true, true, (true|false)>|ILb1ELb1ELb[01]E)",
    }
    out = {name: 0 for name in patterns}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        for name, pattern in patterns.items():
            if re.search(pattern, evt.key):
                out[name] += evt.count
    return out


def robustness_precision(torch, np):
    """(a) Each acceptance case in complex128, exact against mixed: in
    dense mode held to its row's mixed budget, in forced kernel mode with a
    randomized SVD held to kernel_bf16_gemm's budget.  The kernel lane's
    mixed runs are profiled, to show the bf16 instantiations ran."""
    from repro_torch.core.precision import ERROR_BUDGETS, error_budget
    from repro_torch.kernels import dispatch

    cases, psi0 = precision_cases(torch, np, "cuda")
    bf16_tol = error_budget("kernel_bf16_gemm", "mixed")
    rows = []
    lanes = [("dense", False), ("dense", True), ("kernel", True)]
    for mode, randomized in lanes:
        for name, fn in cases.items():
            if mode == "dense" and randomized and name != "contract_onelayer":
                continue   # the table's randomized row is the one-layer's
            prev = dispatch.set_kernel_backend(mode)
            try:
                exact = fn("exact", randomized)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mixed = fn("mixed", randomized)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                dispatch.set_kernel_backend(prev)
            budget = ERROR_BUDGETS[name]["mixed"]
            gap = abs(mixed - exact) / abs(exact)
            row = {"case": name, "mode": mode, "randomized": randomized,
                   "exact": _as_pair(exact), "mixed": _as_pair(mixed),
                   "gap": gap, "budget": budget, "within_budget": gap <= budget,
                   "held_at": budget if mode == "dense" else bf16_tol,
                   "mixed_s": wall}
            if name == "amplitude":
                row["exact_vs_statevector"] = abs(exact - psi0) / abs(psi0)
            rows.append(row)
            emit({"phase": "robustness", "part": "precision", **row})
    for row in rows:
        check(math.isfinite(row["gap"]) and row["gap"] <= row["held_at"],
              f"mixed precision off its bound: {row}")
        if "exact_vs_statevector" in row:
            check(row["exact_vs_statevector"]
                  <= error_budget("amplitude", "exact"),
                  f"exact amplitude vs statevector: {row}")
    # one kernel-lane case again under the profiler (its trace of a whole
    # full-update step takes a minute to collect)
    from torch.profiler import ProfilerActivity, profile
    prev = dispatch.set_kernel_backend("kernel")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cases["contract_twolayer"]("mixed", True)
            torch.cuda.synchronize()
    finally:
        dispatch.set_kernel_backend(prev)
    prof_counts = bf16_instantiations(prof)
    emit({"phase": "robustness", "part": "precision_profile",
          "what": "contract_twolayer, mixed, kernel mode",
          "bf16_instantiations": prof_counts})
    check(all(v > 0 for v in prof_counts.values()),
          f"bf16 instantiations missing from the profile: {prof_counts}")
    return rows, prof_counts


def robustness_main_norm(torch, main):
    """The 8x8 main-path norm under the mixed policy in kernel mode: the
    c128 state demoted to c64 around each solve, the Gram and tall-apply
    sites in bf16; against the c128 exact norm and beside the c64 kernel
    norm of the main_path phase."""
    from repro_torch.core.bmps import BMPS, norm_squared
    from repro_torch.kernels import dispatch

    prev = dispatch.set_kernel_backend("kernel")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        norm = complex(norm_squared(
            main["c128_state"],
            BMPS.randomized(CHI, niter=4, oversample=8, precision="mixed")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dispatch.set_kernel_backend(prev)
    c128, c64 = main["norm_c128_dense"], main["norm_c64_kernel"]
    line = {"phase": "robustness", "part": "main_path_mixed_norm",
            "norm_mixed_kernel": _as_pair(norm),
            "norm_c128_dense": _as_pair(c128),
            "norm_c64_kernel": _as_pair(c64),
            "mixed_vs_c128": rel(norm, c128), "c64_kernel_vs_c128": rel(c64, c128),
            "mixed_s": wall, "c64_kernel_norm_s": main["norm_c64_kernel_s"],
            "c128_norm_s": main["norm_c128_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(line)
    check(all(math.isfinite(x) for x in _as_pair(norm))
          and line["mixed_vs_c128"] <= TOL_MIXED_MAIN,
          f"mixed main-path norm off c128 beyond {TOL_MIXED_MAIN}: {line}")
    return line


def rob_update():
    """The guarded full update: the ite phase's, with als_eps 1e-6 and
    randomized environment sweeps."""
    from repro_torch.core.einsumsvd import RandomizedSVD
    from repro_torch.core.peps import FullUpdate
    return FullUpdate(rank=ITE_RANK, chi=ITE_ENV_CHI, env_refresh_every=40,
                      als_eps=C64_ALS_EPS,
                      env_svd=RandomizedSVD(niter=2, oversample=4))


def rob_ite(torch, steps, **kw):
    """One c64 kernel-mode ite_run of the 4x4 TFI from |0...0>, timed, with
    the kernels' launches over the run."""
    from repro_torch.core.bmps import BMPS
    from repro_torch.core.ite import ite_run
    from repro_torch.core.keys import TorchKey
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.core.peps import computational_zeros
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z

    before = (gram_complex.launches, tall_apply_complex.launches,
              Z.kernel_launches()["zipup_chain"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ite_run(computational_zeros(ITE_GRID, ITE_GRID,
                                      dtype=torch.complex64),
                  tfi_hamiltonian(ITE_GRID, ITE_GRID, jz=-1.0, hx=-3.5),
                  ITE_TAU, steps, rob_update(),
                  BMPS(ITE_MEASURE_CHI), key=TorchKey(SEED),
                  **{"measure_every": ROB_MEASURE_EVERY, **kw})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = (gram_complex.launches, tall_apply_complex.launches,
             Z.kernel_launches()["zipup_chain"])
    launches = dict(zip(TWO_LAYER_KERNELS,
                        (a - b for a, b in zip(after, before))))
    return res, wall, launches


def guard_trail(report):
    return [(e.site, e.cause, e.attempt, e.action) for e in report.events]


def guarded_default_run(torch):
    """The ite phase's complex64 full update at the reference's als_eps
    1e-12 (one step, then the rest from its state, as ``ite_run_line``
    runs it; unguarded, cuSOLVER's eigh raises in it) under one guard."""
    from repro_torch.core import runtime_guard
    from repro_torch.core.bmps import BMPS
    from repro_torch.core.ite import ite_run
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.core.peps import FullUpdate, computational_zeros

    fu = FullUpdate(rank=ITE_RANK, chi=ITE_ENV_CHI, env_refresh_every=40)
    tfi = tfi_hamiltonian(ITE_GRID, ITE_GRID, jz=-1.0, hx=-3.5)
    measure = BMPS(ITE_MEASURE_CHI)
    guard = runtime_guard.RuntimeGuard()
    out = {"als_eps": fu.als_eps, "steps": ITE_STEPS}
    t0 = time.perf_counter()
    try:
        first = ite_run(computational_zeros(ITE_GRID, ITE_GRID,
                                            dtype=torch.complex64),
                        tfi, ITE_TAU, 1, fu, measure, guard=guard)
        rest = ite_run(first.state, tfi, ITE_TAU, ITE_STEPS - 1, fu, measure,
                       measure_every=ITE_STEPS - 1, guard=guard)
        out.update(ended="finished", energies=first.energies + rest.energies)
    except runtime_guard.GuardExhaustedError as e:
        out.update(ended="GuardExhaustedError", site=e.site, cause=e.cause,
                   attempts=e.attempts)
    except torch.linalg.LinAlgError as e:
        out.update(ended="LinAlgError", error=str(e)[:300])
    out.update(events=guard_trail(guard.report),
               counters=guard.report.counters,
               wall_s=time.perf_counter() - t0)
    return out


def robustness_guard(torch, np):
    """(b) The runtime guard on the c64 kernel-mode full update: clean
    guarded against unguarded runs, six armed runs, and the run at the
    reference's als_eps 1e-12 under a guard."""
    import dataclasses
    import warnings
    from repro_torch.core import faults, runtime_guard
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.gram import gram_complex

    out = {}
    prev = dispatch.set_kernel_backend("kernel")
    try:
        plain, plain_s, plain_l = rob_ite(torch, ROB_GUARD_STEPS)
        guarded, guarded_s, guarded_l = rob_ite(torch, ROB_GUARD_STEPS,
                                                guard=True)
        clean = {"energies_plain": plain.energies,
                 "energies_guarded": guarded.energies,
                 "bit_identical": plain.energies == guarded.energies,
                 "launches_plain": plain_l, "launches_guarded": guarded_l,
                 "events": guard_trail(guarded.guard),
                 "rung_dense_kernel": guarded.planner_stats[
                     "guard_rung_dense_kernel"],
                 "s_per_step_plain": plain_s / ROB_GUARD_STEPS,
                 "s_per_step_guarded": guarded_s / ROB_GUARD_STEPS}
        emit({"phase": "robustness", "part": "guard_clean", **clean})
        check(guarded.guard is not None and guarded.guard.events == []
              and clean["bit_identical"] and plain_l == guarded_l
              and clean["rung_dense_kernel"] == 0
              and all(v > 0 for v in plain_l.values()),
              f"a clean guarded run differs from the unguarded one: {clean}")

        armed = {}

        def armed_run(name, site=None, cfg=True, **spec):
            if site is not None:
                faults.arm(site, **spec)
            outcome = {"site": site, **spec}
            try:
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    g0 = gram_complex.launches
                    res, wall, launches = rob_ite(torch, ROB_ARMED_STEPS,
                                                  guard=cfg)
                outcome.update(
                    ended="finished", energies=res.energies,
                    events=guard_trail(res.guard),
                    counters=res.guard.counters, launches=launches,
                    gram_launches=gram_complex.launches - g0,
                    runtime_warnings=sum(issubclass(x.category,
                                                    RuntimeWarning)
                                         for x in w),
                    wall_s=wall)
            except runtime_guard.GuardExhaustedError as e:
                outcome.update(ended="GuardExhaustedError", error_site=e.site,
                               cause=e.cause, attempts=e.attempts,
                               events=guard_trail(
                                   runtime_guard.GuardReport(e.events)))
            finally:
                faults.clear()
            armed[name] = outcome
            emit({"phase": "robustness", "part": "guard_armed", "run": name,
                  **outcome})
            return outcome

        def finished(o):
            return o["ended"] == "finished" and all(
                math.isfinite(e) for e in o["energies"])

        o = armed_run("nan", "einsumsvd.result", nth=1, action="nan")
        check(finished(o) and o["events"][:3] == [
            ("einsumsvd", "nan", 0, "detected"),
            ("einsumsvd", "nan", 1, "retry:exact_svd"),
            ("einsumsvd", "nan", 1, "recovered:exact_svd")]
            and o["counters"].get("guard_recovered") == 1, f"nan: {o}")
        o = armed_run("zero", "einsumsvd.result", nth=1, action="zero")
        check(finished(o) and o["events"][0][1:] == ("collapse", 0, "detected")
              and o["events"][-1][3].startswith("recovered:"), f"zero: {o}")
        o = armed_run("kernel_gram", "kernel.gram", nth=1)
        check(finished(o) and o["events"] == [
            ("einsumsvd", "exception", 0, "detected"),
            ("einsumsvd", "exception", 1, "retry:dense_kernel"),
            ("einsumsvd", "exception", 1, "recovered:dense_kernel")]
            and o["gram_launches"] > 0, f"kernel.gram: {o}")
        cfg = runtime_guard.GuardConfig()
        o = armed_run("exhausted", "einsumsvd.result", nth=1, action="nan",
                      times=cfg.max_retries + 2)
        check(o["ended"] == "GuardExhaustedError"
              and (o["error_site"], o["cause"]) == ("einsumsvd", "nan")
              and o["attempts"] == 2, f"exhausted: {o}")
        floor = runtime_guard.GuardConfig(fidelity_floor=ROB_FIDELITY_FLOOR)
        o = armed_run("fidelity_floor", cfg=floor)
        check(finished(o) and o["counters"].get("guard_degraded_accepted", 0)
              > 0 and o["runtime_warnings"] > 0, f"fidelity floor: {o}")
        strict = dataclasses.replace(floor, fidelity_strict=True)
        o = armed_run("fidelity_strict", cfg=strict)
        check(o["ended"] == "GuardExhaustedError"
              and (o["error_site"], o["cause"]) == ("full_update", "fidelity"),
              f"fidelity strict: {o}")
        out["armed"] = armed

        tight = guarded_default_run(torch)
        emit({"phase": "robustness", "part": "guard_als_eps_1e-12", **tight})
        check(tight["ended"] == "GuardExhaustedError" or (
            tight["ended"] == "finished"
            and all(math.isfinite(e) for e in tight["energies"])),
            f"the guarded als_eps 1e-12 run: {tight}")
        out["clean"], out["als_eps_1e-12"] = clean, tight
    finally:
        dispatch.set_kernel_backend(prev)
    return out, plain


def aligned_gap(fresh, resumed):
    """Largest relative gap of two ITE results' energies aligned by step."""
    a, b = dict(zip(fresh.steps, fresh.energies)), \
        dict(zip(resumed.steps, resumed.energies))
    common = sorted(set(a) & set(b))
    gaps = [abs(a[s] - b[s]) / abs(a[s]) for s in common]
    return (max(gaps) if gaps else math.nan), common, all(
        a[s] == b[s] for s in common)


def robustness_resume(torch, np, fresh):
    """(c) Checkpoint/resume: the c64 kernel-mode full update killed after
    ROB_RESUME_AT steps and resumed to ROB_GUARD_STEPS against the fresh
    run, a torn second write, and the VQE optimizers at the Fig. 14
    setting."""
    import tempfile
    from repro_torch.core import faults
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.core.vqe import run_vqe
    from repro_torch.kernels import dispatch

    out = {}
    prev = dispatch.set_kernel_backend("kernel")
    try:
        with tempfile.TemporaryDirectory() as d:
            _, first_s, _ = rob_ite(torch, ROB_RESUME_AT,
                                    checkpoint_dir=d,
                                    checkpoint_every=ROB_CKPT_EVERY)
            res, resume_s, _ = rob_ite(torch, ROB_GUARD_STEPS,
                                       checkpoint_dir=d,
                                       checkpoint_every=ROB_CKPT_EVERY)
        gap, common, same = aligned_gap(fresh, res)
        out["ite"] = {"resumed_from": res.resumed_from, "steps": common,
                      "max_rel_gap": gap, "bit_identical": same,
                      "killed_run_s": first_s, "resumed_run_s": resume_s}
        emit({"phase": "robustness", "part": "resume_ite", **out["ite"]})
        check(res.resumed_from == ROB_RESUME_AT and len(common) > 1
              and gap <= ROB_RESUME_RTOL, f"ITE resume: {out['ite']}")

        with tempfile.TemporaryDirectory() as d:
            faults.arm("checkpoint.write", nth=2, action="torn")
            try:
                rob_ite(torch, ROB_RESUME_AT, checkpoint_dir=d,
                        checkpoint_every=ROB_CKPT_EVERY)
            finally:
                faults.clear()
            torn = os.path.exists(os.path.join(
                d, f"step_{ROB_RESUME_AT:08d}.tmp"))
            res, _, _ = rob_ite(torch, ROB_RESUME_AT, checkpoint_dir=d,
                                checkpoint_every=ROB_CKPT_EVERY)
        gap, common, same = aligned_gap(fresh, res)
        out["torn"] = {"torn_tmp_left": torn, "resumed_from": res.resumed_from,
                       "steps": common, "max_rel_gap": gap,
                       "bit_identical": same}
        emit({"phase": "robustness", "part": "resume_torn", **out["torn"]})
        check(torn and res.resumed_from == ROB_CKPT_EVERY and len(common) > 0
              and gap <= ROB_RESUME_RTOL, f"torn write: {out['torn']}")
    finally:
        dispatch.set_kernel_backend(prev)

    obs = tfi_hamiltonian(VQE_GRID, VQE_GRID, jz=-1.0, hx=-3.5)
    kw = dict(n_layers=VQE_LAYERS, max_bond=VQE_OPT_RANK,
              contract_bond=VQE_OPT_CHI, seed=SEED)
    for name, extra, total in (
            ("spsa", dict(method="spsa"), ROB_VQE_SPSA_ITERS),
            ("adam", dict(method="adam", ensemble=ROB_VQE_ENSEMBLE),
             ROB_VQE_ADAM_STEPS)):
        half = total // 2
        t0 = time.perf_counter()
        ref = run_vqe(VQE_GRID, VQE_GRID, obs, maxiter=total, **kw, **extra)
        fresh_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as d:
            run_vqe(VQE_GRID, VQE_GRID, obs, maxiter=half, **kw, **extra,
                    checkpoint_dir=d, checkpoint_every=1)
            t0 = time.perf_counter()
            res = run_vqe(VQE_GRID, VQE_GRID, obs, maxiter=total, **kw,
                          **extra, checkpoint_dir=d, checkpoint_every=1)
            resume_s = time.perf_counter() - t0
        same = (res.history == ref.history and res.energy == ref.energy
                and np.array_equal(res.thetas, ref.thetas))
        if name == "adam":
            same = same and np.array_equal(res.ensemble_thetas,
                                           ref.ensemble_thetas)
        out[f"vqe_{name}"] = {"iterations": total, "resumed_from":
                              res.resumed_from, "bit_identical": same,
                              "energy": res.energy, "fresh_s": fresh_s,
                              "resumed_s": resume_s}
        emit({"phase": "robustness", "part": f"resume_vqe_{name}",
              **out[f"vqe_{name}"]})
        check(same and res.resumed_from == half,
              f"VQE {name} resume: {out[f'vqe_{name}']}")
    return out


def phase_robustness(torch, np, main):
    """Precision policies, the runtime guard and checkpoint/resume on the
    card (see the ROB_* constants).  No other phase runs under a guard.
    Returns the kernels' launches over the phase and its headline numbers
    (repeated on the ``done`` line)."""
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z

    t_phase = time.perf_counter()
    gram_complex.launches = tall_apply_complex.launches = 0
    Z.reset_kernel_launches()
    rows, bf16 = robustness_precision(torch, np)
    main_norm = robustness_main_norm(torch, main)
    guard, fresh = robustness_guard(torch, np)
    resume = robustness_resume(torch, np, fresh)
    launches = {"gram_complex": gram_complex.launches,
                "tall_apply_complex": tall_apply_complex.launches,
                **Z.kernel_launches()}
    for k in TWO_LAYER_KERNELS:
        check(launches[k] > 0, f"{k} never launched in the robustness phase")
    summary = {
        "seconds": time.perf_counter() - t_phase,
        "precision_max_gap": {
            lane: max(r["gap"] for r in rows if r["mode"] == lane)
            for lane in ("dense", "kernel")},
        "kernel_rows_over_budget": [r["case"] for r in rows
                                    if r["mode"] == "kernel"
                                    and not r["within_budget"]],
        "bf16_instantiations": bf16,
        "main_path_mixed_vs_c128": main_norm["mixed_vs_c128"],
        "guard_s_per_step": {k: guard["clean"][k] for k in (
            "s_per_step_plain", "s_per_step_guarded")},
        "als_eps_1e-12": guard["als_eps_1e-12"]["ended"],
        "ite_resume_max_rel_gap": resume["ite"]["max_rel_gap"],
        "ite_resume_bit_identical": resume["ite"]["bit_identical"]}
    emit({"phase": "robustness", "launches": launches, **summary})
    return launches, summary


# ---------------------------------------------------------------------------
# A small input against the exact statevector
# ---------------------------------------------------------------------------

def phase_small_reference(torch, np):
    """3x3 at an untruncated chi: the c64 kernel path's norm, energy and
    largest amplitude against the exact c128 statevector of the same
    circuit (bonds reach 4 untruncated)."""
    from repro_torch.core.bmps import BMPS, amplitude, norm_squared
    from repro_torch.core.expectation import expectation
    from repro_torch.core.observable import tfi_hamiltonian
    from repro_torch.core import statevector as sv
    from repro_torch.core.peps import to_statevector
    from repro_torch.core.svd_grad import eigh_reg
    from repro_torch.kernels import dispatch

    rng = np.random.default_rng(SEED + 1)
    thetas = rng.uniform(0.0, 2.0 * np.pi, size=(2, 9))
    obs = tfi_hamiltonian(3, 3)
    psi = to_statevector(build_state(torch, 3, 2, 4, torch.complex128, thetas))
    bits = np.array(np.unravel_index(int(psi.abs().argmax()), psi.shape))
    want = {"norm": complex(sv.inner(psi, psi)),
            "energy": complex(sv.expectation(psi, obs.as_tuples())),
            "amplitude": complex(psi[tuple(int(b) for b in bits)])}
    option = BMPS.randomized(32)
    widened = eigh_reg.widened
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
          "rel_err": errs, "eigh_widened": eigh_reg.widened - widened})
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
    log = build.build_log()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    no_spill = no_spill_ptxas(log)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "no_spill_ptxas": no_spill})

    phase_s = {"build": build_s}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    try:
        for _, label, count in NO_SPILL_KERNELS:
            found = {k: v for k, v in no_spill.items()
                     if k.split("<")[0] == label.split("<")[0]}
            check(len(found) == count and all(
                f.get("spill_stores") == 0 and f.get("spill_loads") == 0
                for f in found.values()),
                f"{label} spills or is missing from the build log: {found}")
        summary = timed("kernels", phase_kernels, torch)
        summary.update(timed("wrappers", phase_wrappers, torch))
        summary.update(timed("lm_kernels", phase_lm_kernels, torch))
        timed("small_reference", phase_small_reference, torch, np)
        launches, state, main_info = timed("main_path", phase_main_path,
                                           torch, np)
        timed("profile", phase_profile, torch, state)
        del state
        torch.cuda.empty_cache()
        by_path = {"peps": dict(launches),
                   "ite": timed("ite", phase_ite, torch, np)}
        torch.cuda.empty_cache()
        by_path["vqe"], vqe_summary = timed("vqe", phase_vqe, torch, np)
        torch.cuda.empty_cache()
        by_path["robustness"], robustness_summary = timed(
            "robustness", phase_robustness, torch, np, main_info)
        del main_info
        torch.cuda.empty_cache()
        for arch in LM_ARCHS:
            by_path[arch] = timed(f"lm_serve_{arch}", phase_lm_serve, torch,
                                  np, arch)
            torch.cuda.empty_cache()
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1

    sources = {"gram": ("src/repro_torch/kernels/csrc/gram.cu",
                        "src/repro/kernels/gram.py:27"),
               "gram_complex": ("src/repro_torch/kernels/csrc/gram.cu",
                                "src/repro/kernels/gram.py:82"),
               "tall_apply": ("src/repro_torch/kernels/csrc/tall_apply.cu",
                              "src/repro/kernels/matvec.py:34"),
               "tall_apply_complex": (
                   "src/repro_torch/kernels/csrc/tall_apply.cu",
                   "src/repro/kernels/matvec.py:92"),
               "tiled_matmul": ("src/repro_torch/kernels/csrc/tiled_matmul.cu",
                                "src/repro/kernels/tiled_matmul.py:26"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:24"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:23"),
               "zipup_pair": (
                   "src/repro_torch/kernels/csrc/zipup_block.cu",
                   "src/repro/kernels/zipup_block.py:42"),
               "zipup_chain": (
                   "src/repro_torch/kernels/csrc/zipup_block.cu",
                   "src/repro/kernels/zipup_block.py:67")}
    kernels = []
    for name, (source, replaces) in sources.items():
        s = summary[name]
        paths = {path: counts[name] for path, counts in by_path.items()
                 if name in counts}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(paths.values()),
                        "launches_by_path": paths,
                        "shape": s["shape"], "max_abs_err": s["max_abs_err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"],
                        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"],
                        **({"device_ms": s["device_ms"]}
                           if "device_ms" in s else {})})
        if name == "zipup_pair":   # the pair merge's kernel too
            kernels[-1]["also_replaces"] = [
                "src/repro/kernels/zipup_block.py:101"]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": phase_s, "vqe": vqe_summary,
          "robustness": robustness_summary})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
