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
the dense torch path and at complex128, and compares.  Then it serves PEPS
queries (``serving`` phase): the launcher's threaded traffic of amplitudes
and observables against the main-path state and a second one, through the
prefix cache and the batched final-row close, held against per-query
amplitudes and cached-environment expectations (bit for bit, whatever the
arrival order), a complex128 case and the launcher itself, the variational
boundary engine at the reference's cases and on the main-path norm, and the
first-row pair merge through its kernel.  Then it runs
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
it serves one model of each LM family at full width (random bf16 weights
from ``SEED``), Zamba2-2.7B (hybrid), Qwen3-4B (dense, GQA 32/8 at head
dimension 128), Mamba2-2.7B (ssm, SSD state 128), Qwen3-30B-A3B (moe, 128
experts, top 8, GQA 32/4) and Qwen2-VL-72B (vlm, M-RoPE positions of a
text-image-text prompt; its published widths at 16 of its 80 layers): a
4 x 2,048 token prefill through the flash-attention and SSD-scan kernels,
64 greedy decode steps, the same prefill through the plain versions, a
prefill-then-decode continuation check (for the moe model where no
assignment drops, on a shorter prompt), and the same bf16 weights read by
f32 activations: kernel vs plain prefill, the continuation check, and the
bf16 model's distance from its f32 self, which sets the bounds of the bf16
checks.  Last, Whisper-large-v3 (encdec) at full width and depth: 4 x 1,500
stub frame embeddings encoded through the flash kernel, the cross K/V of
every decoder layer, the teacher-forced decoder over 64 tokens and as many
decode steps (cross-attention through the kernel), 64 greedy steps, held
the same ways.  Then it trains (``train`` phase): Qwen3-4B at its
published widths and depth, bf16 weights from ``SEED``, f32 AdamW moments,
remat "nothing", five steps of ``python -m repro_torch.launch.train``'s
``main`` on 4 x 2,048-token ``SyntheticLM`` batches (the attention site
runs its plain version under autograd, twice a layer with the recompute),
the validation loss through the flash kernel against the plain versions
within twice the loss's own bf16 floor, and one profiled step with plain
attention's share of its device time; one f32 step of every architecture's
smoke config on the card against the same step on the CPU; and the
launcher killed with ``os._exit(42)`` and resumed in subprocesses, bit for
bit.  Every profiled trace must be whole (``trace_complete``: each kernel
launch the runtime recorded has its device kernel; pad launches at both
ends absorb the records the profiler drops at a trace's edges), or is
taken again, and after three incomplete traces the run fails.  ``python3 chip_smoke.py train`` (or ``kernels``, ``wrappers``,
``lm_kernels``, ``ite``, ``vqe``) runs those phases alone and prints no
result line.  Each phase
prints JSON lines; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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

# PEPS query serving (serving phase): the launcher's traffic
# (src/repro_torch/launch/serve.py) against the main-path state and a second
# 8x8 state of the next seed, in complex64 kernel mode at the main path's
# option.  The hot prefixes are rows 0-6 of likely_bitstrings: in complex64
# a sweep of an unlikely prefix collapses to zeros.
SERVE_CLIENTS = 4
SERVE_QUERIES = 32         # per client
SERVE_OBS_EVERY = 8        # every 8th query is Z(0) + ZZ(0, 1)
SERVE_WINDOW_MS = 2.0
SERVE_BASELINE = 4         # cold per-query amplitudes for the speedup line
# A tight case in complex128, dense: launch/serve.py's default state (4x4
# RQC, 8 layers, circuit seed 7) at chi 8 with DirectSVD, served and batched
# against per-query amplitudes (tests/test_serving.py's bound).
SERVE_TIGHT_GRID = 4
SERVE_TIGHT_LAYERS = 8
SERVE_TIGHT_SEED = 7
SERVE_TIGHT_CHI = 8
TOL_SERVE_C128 = 1e-10
# The launcher itself, at the verify skill's recipe.
SERVE_CLI = ("--grid", "3", "--layers", "4", "--chi", "4", "--states", "2",
             "--clients", "4", "--queries", "10", "--baseline-queries", "4",
             "--device", "cuda")
SERVE_CLI_HOT_PREFIXES = 4  # the launcher's default --hot-prefixes
# The variational engine at the reference's own cases
# (tests/test_engines.py): full chi reproduces the exact contraction (3x3
# one-layer D=3, chi 27, 1e-8), and it beats zip-up at chi 8 (4x4 D=3).
VAR_EXACT_TOL = 1e-8

# Served at full width (lm_serve phases): a model of each family, at full
# depth where one card holds it.  Qwen2-VL-72B's 80 layers take 145 GB in
# bf16: it runs its published widths with 16 layers (about 33 GB).
LM_ARCHS = ("zamba2-2.7b", "qwen3-4b", "mamba2-2.7b", "qwen3-moe-30b-a3b",
            "qwen2-vl-72b")
LM_LAYERS = {"qwen2-vl-72b": 16}
ENCDEC_ARCH = "whisper-large-v3"
LM_BATCH = 4
LM_PROMPT = 2048
LM_DECODE = 64
# Qwen2-VL's M-RoPE layout (arXiv:2409.12191): text, an image grid whose
# tokens share one temporal position and take their row and column, then
# text from the largest position + 1
VL_TEXT = 256
VL_GRID = 32
# The moe continuation check runs where nothing drops, at capacity factor
# n_experts / top_k, on a 4 x 256-token prompt: at 4 x 2,048 tokens that
# capacity's (E + 1, 8,192, D) buffers do not fit beside Qwen3-30B-A3B's
# 61 GB of weights in f32.
MOE_CHECK_PROMPT = 256
# Whisper: the teacher-forced decoder over 64 tokens, the same tokens as
# 64 decode steps, then LM_DECODE greedy steps, in a cache of Whisper's
# 448-token text context
ENC_SEQ = 64
ENC_CONTEXT = 448

# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, bf16 on the tensor cores (dense), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Written between the calls of a cold-L2 timing: more than the 50 MB L2.
FLUSH_BYTES = 128 * 2**20
# Cycles the card sleeps before each cold-L2 call (about 1 ms at 1.98 GHz).
SLEEP_CYCLES = 2_000_000
# Every trace is held to trace_complete: each kernel launch the runtime
# recorded must have its device kernel (the same correlation id).  On the
# H100 (80GB HBM3 at 700 W) a long trace loses the device records of its
# first few launches (1 to 15 in tools/trace_probe.py's traces of 20,000
# to 94,000 launches, 5 and 6 of a c64 norm's 103,934), and now and then
# of its last ones: Kineto counts them "Out-of-range" in its log, as many
# as were lost, and idle margins of 0.25 to 1 s before the work did not
# save them.  So every trace starts and ends with TRACE_PAD_KERNELS
# launches of a small kernel that absorb the loss, and the work's launches
# between them must all have their kernels; an incomplete trace is taken
# again, at most TRACE_ATTEMPTS times in all, and then fails the run.
TRACE_ATTEMPTS = 3
TRACE_PAD_KERNELS = 1000

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
# The floor's own bound holds the three models it was set from (their
# floors read 4.7e-2 to 6.4e-2).  Qwen2-VL-72B's floor reads 0.107 at 16
# layers, alike in its four rows, and grows with depth as rounding
# accumulates (tools/lm_floor_depth.py: 4.8e-2 at 4 layers, 6.6e-2 at 8;
# the hidden state 2.3e-2 off after the first layer, 0.103 after the
# 16th): its attention has no qk-norm, and at d_model 8192 its scores are
# about three times Qwen3-4B's, so a bf16 ulp of q or k moves P further.
# For the later models the floor still sets the bf16 bounds, capped at
# TOL_LM_BF16_FLOOR.
LM_FLOOR_HELD = ("zamba2-2.7b", "qwen3-4b", "mamba2-2.7b")
# prefill(t0..t2046) + decode(t2047) vs prefill(t0..t2047) in f32 at full
# width and depth: allclose with rtol = atol = 2e-2, the contract of
# tests/test_models_smoke.py
TOL_DECODE = 2e-2
# LM training (train phase): Qwen3-4B at its published widths and depth,
# bf16 weights from SEED (lm_serve's), f32 AdamW moments, remat "nothing",
# TRAIN_STEPS steps of the launcher on SyntheticLM batches of TRAIN_BATCH x
# TRAIN_SEQ tokens (TRAIN_BATCH_CUT if that does not fit the card).
TRAIN_ARCH = "qwen3-4b"
TRAIN_BATCH = 4
TRAIN_BATCH_CUT = 2
TRAIN_SEQ = 2048
TRAIN_STEPS = 5
# The launcher's default learning rate (1e-3, no warmup) drove Qwen3-4B's
# loss from 12.4 up to 15.3 in five steps (chip, a probe run).
TRAIN_LR = 1e-4
# One f32 step of every architecture's smoke config, card against CPU:
# loss and each gradient leaf, relative (Frobenius).
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_GRAD = 1e-4
TRAIN_SMOKE_SEQ = 32
# The reference test's chaos recipe (tests/test_fault_tolerance.py): 16
# steps, a checkpoint every 5, killed after step 12, resumed from 10.
TRAIN_CHAOS = ("--arch", "smollm-360m", "--smoke", "--batch", "4", "--seq",
               "32", "--checkpoint-every", "5", "--steps", "16")
TRAIN_CHAOS_KILL = 12
# Plain attention's share of a profiled step: the device time of these ops
# (in the dense model only attention runs batched matmuls, softmax and
# masks), forward, recompute and backward.
PLAIN_ATTENTION_OPS = ("aten::bmm", "aten::_softmax",
                       "aten::_softmax_backward_data", "aten::masked_fill")


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


# The runtime and driver calls that launch a device kernel.
LAUNCH_CALL = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")


def _trace_events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(evt) -> bool:
    return str(evt.device_type()).endswith("CUDA")


def _launches_and_kernels(prof):
    """(a trace's kernel launch records, the runtime's ``cudaLaunchKernel``,
    the driver's ``cuLaunchKernel`` and their variants, as (host start ns,
    correlation id) in the order of their start; the trace's device
    events by correlation id)."""
    launches, device = [], {}
    for evt in _trace_events(prof):
        if _is_device(evt):
            device[evt.correlation_id()] = evt
        elif LAUNCH_CALL.match(evt.name()):
            launches.append((evt.start_ns(), evt.correlation_id()))
    return sorted(launches), device


def trace_complete(prof, pad=0) -> list:
    """The kernel launches of a torch.profiler trace that are left without
    a device kernel: the correlation ids of launch records that no device
    event of the trace carries, leaving out the first and the last ``pad``
    launches (see :func:`traced`).  Empty when the trace is whole."""
    launches, device = _launches_and_kernels(prof)
    return [c for _, c in launches[pad:len(launches) - pad]
            if c not in device]


def trace_record(prof, pad=0) -> dict:
    """A trace's launches between its ``pad`` first and last ones; where
    those lost their kernel, how many and where in launch order (first
    and last index); how many of the pads lost theirs; and the clock skew:
    the most that a kernel's device start precedes its own launch call's
    start on the host clock, in microseconds."""
    launches, device = _launches_and_kernels(prof)
    work = launches[pad:len(launches) - pad]
    lost = [i for i, (_, c) in enumerate(work) if c not in device]
    pads = launches[:pad] + launches[len(launches) - pad:]
    skew = max([0] + [t - device[c].start_ns() for t, c in launches
                      if c in device])
    out = {"launches": len(work),
           "pads_lost": sum(c not in device for _, c in pads),
           "clock_skew_us": skew / 1e3}
    if lost:
        out.update(lost=len(lost), first_lost=lost[0], last_lost=lost[-1])
    return out


def trace_kernels(prof, pad=0) -> dict:
    """Device time by kernel name, {name: [calls, device us]}, of every
    device event of a trace but the ``pad`` first and last launches'."""
    launches, device = _launches_and_kernels(prof)
    pads = {c for _, c in launches[:pad] + launches[len(launches) - pad:]}
    out = {}
    for c, evt in device.items():
        if c in pads:
            continue
        row = out.setdefault(evt.name(), [0, 0.0])
        row[0] += 1
        row[1] += evt.duration_ns() / 1e3
    return out


def traced(torch, fn, what, cpu=True):
    """``fn()`` under torch.profiler (CPU and CUDA activities, or CUDA
    alone) between two runs of TRACE_PAD_KERNELS one-kernel launches,
    held to :func:`trace_complete` over the work's launches.  An
    incomplete trace is taken again, at most TRACE_ATTEMPTS times in all;
    then the run fails.  Returns (device time by kernel of the work,
    :func:`trace_kernels`; wall seconds of the work; the trace's record:
    :func:`trace_record` of the kept trace, the attempts it took and the
    records of the incomplete ones; the profile)."""
    from torch.profiler import ProfilerActivity, profile
    activities = ([ProfilerActivity.CPU] if cpu else []) + [
        ProfilerActivity.CUDA]
    pad = torch.zeros(1024, dtype=torch.uint8, device="cuda")
    incomplete = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(TRACE_PAD_KERNELS):
                pad.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for _ in range(TRACE_PAD_KERNELS):
                pad.add_(1)
            torch.cuda.synchronize()
        record = trace_record(prof, TRACE_PAD_KERNELS)
        if record["launches"] and not trace_complete(prof, TRACE_PAD_KERNELS):
            return (trace_kernels(prof, TRACE_PAD_KERNELS), wall,
                    {"trace": record, "trace_attempts": attempt,
                     "trace_incomplete": incomplete}, prof)
        incomplete.append(record)
    raise CheckFailed(f"{what}: {TRACE_ATTEMPTS} traces incomplete: "
                      f"{incomplete}")


def warm_profiler(torch) -> dict:
    """One throwaway trace of a few kernels before any trace that is read,
    so that the profiler's one-time start-up (seconds on the H100) falls
    here and not in a measured phase; its :func:`traced` record."""
    x = torch.ones(1 << 20, device="cuda")

    def work():
        for _ in range(10):
            x.mul_(1.0)
    return traced(torch, work, "warm_profiler")[2]


def profiled_kernels(torch, fn, calls):
    """Device kernels of ``calls`` calls of ``fn`` under torch.profiler:
    {name: (count, mean device ms)}, from a trace that
    :func:`trace_complete` finds whole."""
    fn()
    torch.cuda.synchronize()

    def work():
        for _ in range(calls):
            fn()
    kernels, _, _, _ = traced(torch, work, f"profiled_kernels x{calls}")
    return {name: (count, us / 1e3 / count)
            for name, (count, us) in kernels.items()}


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
    # GQA and cross shapes in the model's (B, S, H, D) storage: qwen3-4b's
    # (32 query heads over 8 KV heads, d = 128) and qwen3-moe-30b-a3b's (32
    # over 4: GQA group 8), timed; smollm-360m's (15 over 5: GQA group 3,
    # an odd head count), held only; whisper-large-v3's encoder (20 heads,
    # d = 64, 1,500 frames, full attention, the last 64-key tile ragged),
    # timed; and its cross-attention of 64 decoder tokens and of one token
    # over 1,500 frames, held only
    for b, hq, hkv, s, sk, d, causal, timed in (
            (LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 128, True, True),
            (LM_BATCH, 15, 5, LM_PROMPT, LM_PROMPT, 64, True, False),
            (LM_BATCH, 32, 4, LM_PROMPT, LM_PROMPT, 128, True, True),
            (LM_BATCH, 20, 20, 1500, 1500, 64, False, True),
            (LM_BATCH, 20, 20, ENC_SEQ, 1500, 64, False, False),
            (LM_BATCH, 20, 20, 1, 1500, 64, False, False)):
        q = randn(b, s, hq, d, dtype=torch.bfloat16).transpose(1, 2)
        k, v = (randn(b, sk, hkv, d, dtype=torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        want = KF.flash_attention_plain(q, k, v, causal=causal)
        line = held(torch, "flash_attention", [b, hq, hkv, s, sk, d],
                    KF.flash_attention(q, k, v, causal=causal), want,
                    TOL_BF16_OUT, dtype="bfloat16", causal=causal)
        within_witness(line, q, k, v, want, causal)
        if timed:
            # each product: the causal half, or every (query, key) pair
            product = (s * (s + 1) if causal else 2 * s * sk) * d * b * hq
            nbytes = 2 * 2 * b * d * (hq * s + hkv * sk)
            measure_line(
                torch, line, lambda q=q, k=k, v=v: KF.flash_attention(
                    q, k, v, causal=causal),
                lambda q=q, k=k, v=v: KF.flash_attention_plain(
                    q, k, v, causal=causal),
                lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), 0.0, nbytes,
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
    # for the serving phase's per-query amplitudes and variational norm
    main = {"c128_state": anchor_state, "norm_c128_dense": anchor["norm"],
            "norm_c64_kernel": kern["norm"], "norm_c128_s": anchor["norm_s"],
            "norm_c64_kernel_s": kern["norm_s"], "bits_list": bits_list,
            "amplitudes_c64_kernel": list(kern["amplitudes"])}
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

        def norm():
            gram_complex.launches = tall_apply_complex.launches = 0
            Z.reset_kernel_launches()
            norm_squared(state, option)
        kernels, wall, trace, _ = traced(torch, norm, "profile norm_squared")
    finally:
        dispatch.set_kernel_backend(prev)
    emit({"phase": "profile", "what": "norm_squared, complex64, kernel mode",
          "launches_per_norm": {
              "gram_complex": gram_complex.launches,
              "tall_apply_complex": tall_apply_complex.launches,
              **Z.kernel_launches()},
          **trace, **device_profile(kernels, wall, focus=("zipup",))})


def device_profile(kernels, wall: float, focus=()):
    """Device time by kernel (``kernels``, as :func:`traced` returns them)
    over ``wall`` seconds of work, and the device's busy share of that
    wall time; every kernel whose name holds one of the ``focus`` words
    is listed as well."""
    rows = sorted(((us, name, count) for name, (count, us)
                   in kernels.items()), reverse=True)
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
# PEPS query serving and the variational engine (serving phase)
# ---------------------------------------------------------------------------

def reset_peps_launches() -> None:
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z
    gram_complex.launches = tall_apply_complex.launches = 0
    Z.reset_kernel_launches()


def peps_launches() -> dict:
    from repro_torch.kernels.gram import gram_complex
    from repro_torch.kernels.matvec import tall_apply_complex
    from repro_torch.kernels import zipup_block as Z
    return {"gram_complex": gram_complex.launches,
            "tall_apply_complex": tall_apply_complex.launches,
            **Z.kernel_launches()}


def percentiles_ms(lat_s) -> dict:
    """p50/p95/p99 in ms, picked as the launcher picks them."""
    lat = sorted(x * 1e3 for x in lat_s)
    pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
    return {"n": len(lat), "p50": pick(0.50), "p95": pick(0.95),
            "p99": pick(0.99)} if lat else {"n": 0}


def serving_traffic(torch, np, state, main):
    """(a) The launcher's traffic against the main-path state and a second
    8x8 state, c64, forced kernel mode, the main path's option.  Returns
    the line and the kernels' launches while serving it."""
    import threading
    from repro_torch.core.bmps import BMPS, amplitude
    from repro_torch.core.environments import row_environments
    from repro_torch.core.expectation import DEFAULT_EXPECTATION_KEY_SEED, \
        expectation_from_envs
    from repro_torch.core.keys import TorchKey
    from repro_torch.core.observable import Observable
    from repro_torch.core.serving import ServingEngine

    option = BMPS.randomized(CHI, niter=4, oversample=8)
    thetas = np.random.default_rng(SEED + 1).uniform(
        0.0, THETA_MAX, size=(LAYERS, GRID * GRID))
    states = {"main": state,
              "next": build_state(torch, GRID, LAYERS, RANK, torch.complex64,
                                  thetas)}
    hot = {"main": np.stack(main["bits_list"]).reshape(-1, GRID, GRID),
           "next": np.stack(likely_bitstrings(np, thetas, GRID, N_AMPLITUDES)
                            ).reshape(-1, GRID, GRID)}
    prefixes = {name: {b[:-1].tobytes() for b in bits}
                for name, bits in hot.items()}
    obs = Observable.Z(0) + Observable.ZZ(0, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_peps_launches()
    engine = ServingEngine(window_ms=SERVE_WINDOW_MS)
    for name, st in states.items():
        engine.register_state(name, st, option)
    t0 = time.perf_counter()
    warm = {name: engine.amplitude_batch(name, bits)
            for name, bits in hot.items()}
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    names = list(states)
    records = []          # (client seed, kind, name, bits, future)
    lock = threading.Lock()

    def client(seed, lat):
        crng = np.random.default_rng(seed)
        pending = []
        for q in range(SERVE_QUERIES):
            name = names[crng.integers(len(names))]
            if (q + 1) % SERVE_OBS_EVERY == 0:
                kind, bits = "obs", None
                t = time.perf_counter()
                fut = engine.submit_expectation(name, obs)
            else:
                kind = "amp"
                bits = hot[name][crng.integers(len(hot[name]))].copy()
                bits[-1] = crng.integers(0, 2, GRID)
                t = time.perf_counter()
                fut = engine.submit_amplitude(name, bits)
            pending.append((kind, t, fut))
            with lock:
                records.append((seed, kind, name, bits, fut))
        for kind, t, fut in pending:
            if fut.exception(timeout=600) is None:
                with lock:
                    lat[kind].append(time.perf_counter() - t)

    def traffic_round(seed):
        """The launcher's clients, one thread each; q/s and latencies."""
        lat = {"amp": [], "obs": []}
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(seed + i, lat))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = len(lat["amp"]) + len(lat["obs"])
        return {"wall_s": wall, "queries": total, "q_per_s": total / wall,
                "amplitude_latency_ms": percentiles_ms(lat["amp"]),
                "observable_latency_ms": percentiles_ms(lat["obs"])}

    # the first round builds each state's observable environments as its
    # first expectation query arrives; in the second every cache is warm
    rounds = {"first": traffic_round(1000), "steady": traffic_round(2000)}
    launches = peps_launches()
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()
    engine.close()
    pending = [r for r in records if not r[4].done()]
    check(not pending, f"{len(pending)} futures pending after close()")
    failed = [(r[1], r[2], repr(r[4].exception())) for r in records
              if r[4].exception() is not None]
    check(not failed, f"served futures resolved to errors: {failed[:4]}")

    # cold per-query contraction against the served batch (the launcher's
    # speedup line); these launches do not count
    base = np.repeat(hot["main"][:1], SERVE_BASELINE, axis=0)
    base[:, -1] = np.random.default_rng(SEED).integers(
        0, 2, (SERVE_BASELINE, GRID))
    t0 = time.perf_counter()
    cold_vals = [complex(amplitude(state, b, option)) for b in base]
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) / SERVE_BASELINE
    t0 = time.perf_counter()
    served_vals = [complex(v) for v in engine.amplitude_batch("main", base)]
    torch.cuda.synchronize()
    served = (time.perf_counter() - t0) / SERVE_BASELINE

    # the same unlikely bitstrings per query in c128 (dense by its dtype):
    # which c64 value, served or per-query, keeps the amplitude
    c128_vals = [complex(amplitude(main["c128_state"], b, option))
                 for b in base]

    # served against per-query: the main path's four amplitudes, same
    # option and key
    per_query = main["amplitudes_c64_kernel"]
    gap_main = max(rel(complex(v), p) for v, p in zip(warm["main"], per_query))
    # arrival order changes no value: the threaded results against one
    # synchronous batch of the same bits
    mismatched = 0
    for name in names:
        recs = [r for r in records if r[1] == "amp" and r[2] == name]
        sync = engine.amplitude_batch(name, np.stack([r[3] for r in recs]))
        mismatched += sum(complex(r[4].result()) != complex(v)
                          for r, v in zip(recs, sync))
    # a served expectation against expectation_from_envs on fresh row
    # environments of the same key
    obs_gap = {}
    for name in names:
        served_e = {complex(r[4].result()) for r in records
                    if r[1] == "obs" and r[2] == name}
        top, bottom = row_environments(
            states[name], option, TorchKey(DEFAULT_EXPECTATION_KEY_SEED))
        want = complex(expectation_from_envs(states[name], obs, top, bottom))
        obs_gap[name] = {"served": [_as_pair(v) for v in served_e],
                         "direct": _as_pair(want),
                         "bit_identical": served_e == {want}}
    line = {"phase": "serving", "part": "traffic", "dtype": "complex64",
            "mode": "kernel", "chi": CHI, "clients": SERVE_CLIENTS,
            "queries_per_client": SERVE_QUERIES, "window_ms": SERVE_WINDOW_MS,
            "warm_s": warm_s, **rounds,
            "cold_ms": cold * 1e3, "served_ms": served * 1e3,
            "speedup": cold / served,
            "served_vs_per_query_main_path": gap_main,
            # unlikely final rows: a per-query c64 value may have collapsed
            "baseline_abs": {"served": [abs(v) for v in served_vals],
                             "per_query": [abs(v) for v in cold_vals],
                             "per_query_c128": [abs(v) for v in c128_vals]},
            "baseline_vs_c128": {
                "served": [rel(v, w) for v, w in zip(served_vals, c128_vals)],
                "per_query": [rel(v, w) for v, w in zip(cold_vals,
                                                        c128_vals)]},
            "threaded_vs_sync_mismatches": mismatched,
            "expectation": obs_gap,
            "distinct_prefixes": {k: len(v) for k, v in prefixes.items()},
            "stats": {k: v for k, v in stats.items() if k != "per_state"},
            "per_state": stats["per_state"], "launches": launches,
            "max_memory_allocated": peak}
    emit(line)
    # only the likely bitstrings are held: a per-query c64 amplitude of an
    # unlikely final row can collapse in its truncated last absorption,
    # which the exact close does not have (baseline_abs shows both)
    check(gap_main <= TOL_FULL,
          f"served vs per-query: {gap_main} > {TOL_FULL}")
    check(mismatched == 0, f"{mismatched} threaded amplitudes differ from "
          f"a synchronous batch of the same bits")
    for name, g in obs_gap.items():
        check(g["bit_identical"], f"served expectation of {name}: {g}")
    for name, ps in stats["per_state"].items():
        check(ps["prefix_misses"] <= len(prefixes[name]),
              f"{name}: {ps['prefix_misses']} prefix misses for "
              f"{len(prefixes[name])} prefixes")
        check(ps["obs_env_builds"] == 1, f"{name}: obs_env_builds {ps}")
    n_prefixes = sum(len(v) for v in prefixes.values())
    check(stats["rows_absorbed"] <= (GRID - 2) * n_prefixes,
          f"rows_absorbed {stats['rows_absorbed']} for {n_prefixes} prefixes")
    return line, launches


def serving_tight(torch, np):
    """(b) c128 dense on the card: served and ``bmps.amplitudes`` against
    per-query amplitudes at 1e-10 on the launcher's default state, then the
    launcher itself at the verify skill's recipe."""
    from repro_torch.core import bmps as B
    from repro_torch.core.serving import ServingEngine
    from repro_torch.launch import serve

    state = serve.build_states(1, SERVE_TIGHT_GRID, SERVE_TIGHT_LAYERS,
                               seed=SERVE_TIGHT_SEED, device="cuda")[0]
    option = B.BMPS(SERVE_TIGHT_CHI)
    rng = np.random.default_rng(SEED)
    g = SERVE_TIGHT_GRID
    bits = np.repeat(rng.integers(0, 2, (4, g - 1, g)), 4, axis=0)
    bits = np.concatenate([bits, rng.integers(0, 2, (16, 1, g))], axis=1)
    direct = torch.stack([B.amplitude(state, b, option) for b in bits])
    with ServingEngine(start=False) as engine:
        engine.register_state("rqc", state, option)
        served = engine.amplitude_batch("rqc", bits)
    batched = B.amplitudes(state, bits, option)
    gaps = {"served": rel_gap(torch, served, direct),
            "amplitudes": rel_gap(torch, batched, direct)}
    t0 = time.perf_counter()
    cli = serve.main(list(SERVE_CLI))
    cli_s = time.perf_counter() - t0
    line = {"phase": "serving", "part": "tight_c128", "grid": g,
            "layers": SERVE_TIGHT_LAYERS, "chi": SERVE_TIGHT_CHI,
            "svd": "direct", "max_bond": state.max_bond(),
            "queries": len(bits), "rel_err_vs_per_query": gaps,
            "tol": TOL_SERVE_C128, "launcher": {
                "argv": list(SERVE_CLI), "seconds": cli_s,
                "per_state": cli["per_state"],
                **{k: v for k, v in cli.items() if k != "per_state"}}}
    emit(line)
    for k, v in gaps.items():
        check(v <= TOL_SERVE_C128, f"c128 {k} vs per-query: {gaps}")
    for name, ps in cli["per_state"].items():
        check(ps["prefix_misses"] <= SERVE_CLI_HOT_PREFIXES,
              f"launcher {name}: {ps}")
    return line


def serving_variational(torch, np, state, main):
    """(c) The variational engine: the reference's cases in c128, then the
    8x8 main-path norm in c64 kernel mode against the main path's c128
    zip-up norm.  Returns the line and the launches of the 8x8 norm."""
    from repro_torch.core import bmps as B
    from repro_torch.core.keys import TorchKey
    from repro_torch.core.peps import random_onelayer
    from repro_torch.kernels import dispatch

    def onelayer(grid, bond, seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return random_onelayer(grid, grid, bond, gen, device="cuda")

    prev = dispatch.set_kernel_backend("dense")
    try:
        rows = onelayer(3, 3, SEED)
        exact = complex(B.contract_exact_onelayer(rows))
        full = complex(B.contract_onelayer(
            rows, B.BMPS(27, engine="variational"), key=TorchKey(3)))
        rows = onelayer(4, 3, SEED + 1)
        exact4 = complex(B.contract_exact_onelayer(rows))
        err_zip = rel(complex(B.contract_onelayer(rows, B.BMPS(8),
                                                  key=TorchKey(17))), exact4)
        err_var = rel(complex(B.contract_onelayer(
            rows, B.BMPS(8, engine="variational"), key=TorchKey(17))), exact4)
    finally:
        dispatch.set_kernel_backend(prev)

    option = B.BMPS.randomized(CHI, niter=4, oversample=8,
                               engine="variational")
    prev = dispatch.set_kernel_backend("kernel")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_peps_launches()
        t0 = time.perf_counter()
        norm = complex(B.norm_squared(state, option))
        torch.cuda.synchronize()
        var_s = time.perf_counter() - t0
        launches = peps_launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        dispatch.set_kernel_backend(prev)
    c128 = main["norm_c128_dense"]
    line = {"phase": "serving", "part": "variational",
            "full_chi_3x3_vs_exact": rel(full, exact),
            "chi8_4x4_vs_exact": {"zipup": err_zip, "variational": err_var},
            "main_norm": {"variational_c64_kernel": _as_pair(norm),
                          "zipup_c64_kernel": _as_pair(main["norm_c64_kernel"]),
                          "zipup_c128_dense": _as_pair(c128),
                          "variational_vs_c128": rel(norm, c128),
                          "zipup_c64_vs_c128": rel(main["norm_c64_kernel"],
                                                   c128),
                          "variational_s": var_s,
                          "zipup_c64_kernel_s": main["norm_c64_kernel_s"],
                          "max_memory_allocated": peak},
            "sweeps": 2, "launches": launches, "tol_anchor": TOL_ANCHOR}
    emit(line)
    check(rel(full, exact) <= VAR_EXACT_TOL,
          f"variational at full chi vs exact: {rel(full, exact)}")
    check(err_var < err_zip, f"variational {err_var} not below zip-up "
          f"{err_zip} at chi 8")
    check(math.isfinite(norm.real) and rel(norm, c128) <= TOL_ANCHOR,
          f"8x8 variational norm vs c128: {rel(norm, c128)}")
    return line, launches


def serving_pair_merge(torch, state):
    """(d) ``_init_twolayer_boundary`` on row 0 of the main-path state:
    kernel mode (one ``zipup_pair`` launch a column through the pair_merge
    site) against dense."""
    from repro_torch.core.engines.zipup import _init_twolayer_boundary
    from repro_torch.kernels import dispatch

    row = state.sites[0]
    prev = dispatch.set_kernel_backend("kernel")
    try:
        reset_peps_launches()
        calls = dispatch.dispatch_stats()["kernel_pair_merge_calls"]
        got = _init_twolayer_boundary(row, row)
        torch.cuda.synchronize()
        launches = peps_launches()
        calls = dispatch.dispatch_stats()["kernel_pair_merge_calls"] - calls
    finally:
        dispatch.set_kernel_backend(prev)
    with dispatch.forced_dense():
        want = _init_twolayer_boundary(row, row)
    errs = [rel_gap(torch, g, w) for g, w in zip(got, want)]
    line = {"phase": "serving", "part": "pair_merge", "columns": len(row),
            "shapes": [list(t.shape) for t in got], "site_calls": calls,
            "launches": launches, "rel_err": max(errs), "tol": TOL_F32}
    emit(line)
    check(calls == len(row) and launches["zipup_pair"] == len(row),
          f"pair merge: {calls} site calls, {launches} for {len(row)} columns")
    check(max(errs) <= TOL_F32, f"pair merge kernel vs dense: {errs}")
    return launches


def phase_serving(torch, np, state, main):
    """PEPS items 1, 5 and 8 on the card: served amplitudes and
    observables at full size, a tight c128 case and the launcher, the
    variational engine, and the pair merge on a path.  Returns the
    kernels' launches over the served traffic, the variational 8x8 norm
    and the pair merge, and the phase's headline numbers."""
    from repro_torch.kernels import dispatch

    t_phase = time.perf_counter()
    prev = dispatch.set_kernel_backend("kernel")
    try:
        traffic, l_traffic = serving_traffic(torch, np, state, main)
    finally:
        dispatch.set_kernel_backend(prev)
    tight = serving_tight(torch, np)
    var, l_var = serving_variational(torch, np, state, main)
    l_pair = serving_pair_merge(torch, state)
    launches = {k: l_traffic[k] + l_var[k] + l_pair[k] for k in l_traffic}
    for k in ("gram_complex", "tall_apply_complex", "zipup_pair",
              "zipup_chain"):
        check(launches[k] > 0, f"{k} never launched in the serving phase")
    summary = {
        "seconds": time.perf_counter() - t_phase,
        "q_per_s": {k: traffic[k]["q_per_s"] for k in ("first", "steady")},
        "amplitude_p50_ms": {k: traffic[k]["amplitude_latency_ms"]["p50"]
                             for k in ("first", "steady")},
        "speedup": traffic["speedup"],
        "served_vs_per_query": traffic["served_vs_per_query_main_path"],
        "c128_served_vs_per_query": tight["rel_err_vs_per_query"]["served"],
        "variational_vs_c128": var["main_norm"]["variational_vs_c128"]}
    emit({"phase": "serving", "launches": launches, **summary})
    return launches, summary


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

        def step():
            gram_complex.launches = tall_apply_complex.launches = 0
            Z.reset_kernel_launches()
            trotter_step(state, moments, update, key, envs, since)
        kernels, wall, trace, _ = traced(torch, step, f"ite_profile {label}")
    finally:
        dispatch.set_kernel_backend(prev)
    emit({"phase": "ite_profile", "what": label,
          "launches_per_step": {
              "gram_complex": gram_complex.launches,
              "tall_apply_complex": tall_apply_complex.launches,
              **Z.kernel_launches()}, **trace,
          **device_profile(kernels, wall, focus=("gram_tile", "gram_reduce",
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


@contextlib.contextmanager
def sites_in(mode):
    """Every kernel site in ``mode`` ("kernel", "dense" or "auto")."""
    from repro_torch.kernels import dispatch
    prev = dispatch.set_kernel_backend(mode)
    try:
        yield
    finally:
        dispatch.set_kernel_backend(prev)


def prefill_in(torch, T, mode, params, cfg, tokens, max_seq,
               cache_dtype=None, positions=None):
    """One prefill with every site in ``mode``; (logits, cache, seconds).
    The cache is bf16 unless ``cache_dtype`` says otherwise."""
    with sites_in(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, tokens, max_seq,
                                  positions=positions,
                                  cache_dtype=cache_dtype or torch.bfloat16)
        torch.cuda.synchronize()
        return logits, cache, time.perf_counter() - t0


def served_launches(cfg):
    """The kernels' launches in one prefill of ``cfg``'s decoder-only
    stack: one ``flash_attention`` per attention layer, one ``ssd_scan`` per
    Mamba2 layer (decode launches neither)."""
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_group
        return {"flash_attention": n_groups,
                "ssd_scan": n_groups * (cfg.hybrid_group - 1)}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "ssd_scan": cfg.n_layers}
    return {"flash_attention": cfg.n_layers, "ssd_scan": 0}   # dense/moe/vlm


def encdec_launches(cfg):
    """``flash_attention`` launches of the encoder-decoder's entries: one
    per encoder layer in ``encode``, a causal and a cross one per decoder
    layer in ``decode_train``, one cross per decoder layer in a decode step
    (self-attention decode is plain)."""
    return {"encode": cfg.n_enc_layers, "decode_train": 2 * cfg.n_layers,
            "decode_step": cfg.n_layers}


def lm_config(arch):
    """``arch``'s served config and its cuts, {field: [published, served]}."""
    import dataclasses
    from repro_torch.configs import get
    cfg, reduced = get(arch), {}
    if arch in LM_LAYERS:
        reduced["n_layers"] = [cfg.n_layers, LM_LAYERS[arch]]
        cfg = dataclasses.replace(cfg, n_layers=LM_LAYERS[arch])
    return cfg, reduced


def vl_positions(torch, batch, length):
    """(3, B, length) M-RoPE positions in Qwen2-VL's layout: VL_TEXT text
    tokens (t = h = w = i), a VL_GRID x VL_GRID image (t = VL_TEXT, h =
    VL_TEXT + row, w = VL_TEXT + column), then text from the largest
    position + 1 (all three streams equal)."""
    cell = torch.arange(VL_GRID * VL_GRID)
    text = torch.arange(VL_TEXT)
    after = VL_TEXT + VL_GRID + torch.arange(length - VL_TEXT - cell.numel())
    streams = [torch.full_like(cell, VL_TEXT), VL_TEXT + cell // VL_GRID,
               VL_TEXT + cell % VL_GRID]
    pos = torch.stack([torch.cat([text, s, after]) for s in streams])
    return pos[:, None].expand(3, batch, length).to(torch.int32).cuda()


def weight_bytes(params, skip=()):
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for path, t in tree_leaves(params)
               if path[0] not in skip)


@contextlib.contextmanager
def moe_routes(record=None, replay=None):
    """Every ``moe._route`` call made inside appends its ``Route`` to
    ``record``; with ``replay`` (an earlier run's record), the calls return
    those routes in order instead: that run's expert choices, pinned."""
    from repro_torch.models import moe
    route, pinned = moe._route, None if replay is None else iter(replay)

    def hooked(*args, **kwargs):
        r = route(*args, **kwargs) if pinned is None else next(pinned)
        if record is not None:
            record.append(r)
        return r

    moe._route = hooked
    try:
        yield
    finally:
        moe._route = route


def draw_params(torch, bundle, out):
    """The bundle's bf16 weights drawn on the card from SEED, with the
    draw's time, size and peak in ``out``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = weight_bytes(params)
    # the draw's f32 slices peak above what serving holds: the served peak
    # (weights, cache, activations) is read from here on
    out["init_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return params


def attention_counters(dispatch):
    return {k: v for k, v in dispatch.dispatch_stats().items()
            if k.endswith(("_attention_calls", "_ssd_calls",
                           "_attention_grad_calls", "_ssd_grad_calls"))}


def greedy_agree(a, b) -> str:
    """How many rows of two logits (B, V) pick the same greedy token."""
    same = (a.argmax(dim=-1) == b.argmax(dim=-1)).sum().item()
    return f"{same}/{a.shape[0]}"


def phase_lm_serve(torch, np, arch):
    """``arch`` at full width (and full depth, or the depth of LM_LAYERS)
    with bf16 weights drawn on the card from SEED: prefill 4 x 2,048
    tokens through the kernels, decode 64 greedy tokens, and check (a)
    finite logits, (b) kernel vs plain prefill logits and (c) prefill +
    decode against the longer prefill, each in bf16 and in f32 (the same
    bf16 weights read by f32 activations).  The bf16 bounds come from the
    measured distance of the plain bf16 prefill from the plain f32 one.
    A moe model's continuation check runs where nothing drops (see
    MOE_CHECK_PROMPT); a vlm model takes the M-RoPE positions of
    ``vl_positions``.  Returns the kernels' launch counts of the served
    prefill and decode."""
    import dataclasses
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import fits, ssd_scan
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build

    t_phase = time.perf_counter()
    cfg, reduced = lm_config(arch)
    per_prefill = served_launches(cfg)
    bundle = build(cfg)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(LM_BATCH, LM_PROMPT))).cuda()
    max_seq = LM_PROMPT + LM_DECODE
    pos_all = (vl_positions(torch, LM_BATCH, max_seq)
               if cfg.mrope_sections is not None else None)

    def pos(lo, hi):
        return None if pos_all is None else pos_all[..., lo:hi]

    out = {"phase": "lm_serve", "arch": arch, "family": cfg.family,
           "n_layers": cfg.n_layers, "reduced": reduced, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "decode_tokens": LM_DECODE}
    if pos_all is not None:
        out["positions"] = (f"M-RoPE: {VL_TEXT} text, a {VL_GRID} x "
                            f"{VL_GRID} image grid, text from "
                            f"{VL_TEXT + VL_GRID}")
    with torch.no_grad():
        params = draw_params(torch, bundle, out)
        # a decode step reads every weight but the embedding table
        out["decode_bound_ms"] = (weight_bytes(params, skip=("embed",))
                                  / PEAK_BYTES * 1e3)

        # the served run: every count starts at 0 and is read right after
        dispatch.reset_dispatch_stats()
        flash_attention.launches = 0
        ssd_scan.launches = 0
        logits, cache, out["prefill_s"] = prefill_in(
            torch, T, "kernel", params, cfg, tokens, max_seq,
            positions=pos(0, LM_PROMPT))
        prefill_launches = {"flash_attention": flash_attention.launches,
                            "ssd_scan": ssd_scan.launches}
        finite = torch.isfinite(logits).all()
        tok = logits.argmax(dim=-1, keepdim=True)
        generated = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LM_PROMPT, max_seq):
            step_logits, cache = bundle.serve_step(params, cache, tok,
                                                   pos(i, i + 1))
            finite &= torch.isfinite(step_logits).all()
            tok = step_logits.argmax(dim=-1, keepdim=True)
            generated.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counters = attention_counters(dispatch)
        launches = {"flash_attention": flash_attention.launches,
                    "ssd_scan": ssd_scan.launches}
        out.update(
            decode_ms_per_token=decode_s / LM_DECODE * 1e3,
            decode_tokens_per_s=LM_BATCH * LM_DECODE / decode_s,
            prefill_tokens_per_s=LM_BATCH * LM_PROMPT / out["prefill_s"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            prefill_launches=prefill_launches, launches=launches,
            counters=counters,
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

        # the same prefill again (warm; a moe model's routing tallied), and
        # through the plain versions
        routes = []
        with moe_routes(record=routes):
            logits2, _, out["prefill_warm_s"] = prefill_in(
                torch, T, "kernel", params, cfg, tokens, max_seq,
                positions=pos(0, LM_PROMPT))
        out["prefill_repeats_bitwise"] = bool(torch.equal(logits, logits2))
        if routes:
            out["moe_capacity_factor"] = cfg.capacity_factor
            out["moe_dropped_share"] = 1 - sum(
                r.keep.sum().item() for r in routes) / sum(
                r.keep.numel() for r in routes)
        del routes
        kernels, wall, trace, _ = traced(
            torch, lambda: prefill_in(torch, T, "kernel", params, cfg, tokens,
                                      max_seq, positions=pos(0, LM_PROMPT)),
            f"lm_profile {arch} prefill")
        prof_line = {"phase": "lm_profile", "arch": arch,
                     "what": f"one kernel-mode prefill, {LM_BATCH} x "
                     f"{LM_PROMPT} tokens, bf16", **trace,
                     **device_profile(kernels, wall, focus=("ssd_", "flash_"))}
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
        # the step writes its K/V at LM_PROMPT, the same slot on a retry
        kernels, wall, trace, _ = traced(
            torch, lambda: bundle.serve_step(params, step_cache,
                                             tokens[:, -1:],
                                             pos(LM_PROMPT, LM_PROMPT + 1)),
            f"lm_profile {arch} decode step")
        emit({"phase": "lm_profile", "arch": arch, "what": f"one decode "
              f"step, batch {LM_BATCH}, bf16", **trace,
              **device_profile(kernels, wall)})
        del step_cache, cache, logits2
        dense, _, out["prefill_dense_s"] = prefill_in(
            torch, T, "dense", params, cfg, tokens, max_seq,
            positions=pos(0, LM_PROMPT))
        out["bf16_kernel_vs_dense"], _ = logits_gap(torch, logits, dense)
        out["bf16_greedy_agree_kernel_vs_dense"] = greedy_agree(logits, dense)

        # the same weights read by f32 activations: every use casts its
        # weight to the activation's dtype, so this is the model with its
        # bf16 weights held in f32, exactly.  (b) and (c) as rounding
        # comparisons, and the bf16 model's rounding floor.  Where the f32
        # SSD kernel does not fit the state (mamba2's N = 128), "auto" runs
        # the SSD dense, as it does for any f32 caller: then the bf16
        # checks hold the SSD kernel on this path, and the kernels phase
        # holds it at the same shape against its witness.
        cfg32 = dataclasses.replace(cfg, act_dtype=torch.float32)
        out["f32_weights"] = "the bf16 weights, read by f32 activations"
        f32_mode = "kernel"
        if cfg.family in ("ssm", "hybrid") and not fits(
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
        torch.cuda.empty_cache()
        dispatch.reset_dispatch_stats()
        kern_routes, dense_routes = [], []
        with moe_routes(record=kern_routes):
            kern32, kcache, out["f32_prefill_s"] = prefill_in(
                torch, T, f32_mode, params, cfg32, tokens, LM_PROMPT,
                torch.float32, positions=pos(0, LM_PROMPT))
        out["f32_counters"] = attention_counters(dispatch)
        with moe_routes(record=dense_routes):
            dense32, dcache, out["f32_prefill_dense_s"] = prefill_in(
                torch, T, "dense", params, cfg32, tokens, LM_PROMPT,
                torch.float32, positions=pos(0, LM_PROMPT))
        plain32 = dense32
        if kern_routes:
            # A router near a top-k tie picks another expert when the
            # attention's rounding moves its input, and with capacity-
            # limited experts that shifts the ranks, and so the drops, of
            # every later assignment to both experts: the kernel and plain
            # runs then differ by discrete choices, not by rounding.  The
            # rounding comparison runs the plain version with the kernel
            # run's routes pinned; the unpinned gap and the number of
            # assignments routed apart are printed beside it.
            out["f32_routing_differences"] = sum(
                int((a.slot_e != b.slot_e).sum())
                for a, b in zip(kern_routes, dense_routes))
            out["f32_kernel_vs_dense_unpinned"], _ = logits_gap(
                torch, kern32, dense32)
            del dcache
            with moe_routes(replay=kern_routes):
                plain32, dcache, _ = prefill_in(
                    torch, T, "dense", params, cfg32, tokens, LM_PROMPT,
                    torch.float32, positions=pos(0, LM_PROMPT))
            out["f32_plain_routes"] = "pinned to the kernel run's"
        del kern_routes, dense_routes
        out["f32_kernel_vs_dense"], _ = logits_gap(torch, kern32, plain32)
        out["f32_greedy_agree_kernel_vs_dense"] = greedy_agree(kern32, plain32)
        out["f32_cache_kernel_vs_dense"] = {
            key: logits_gap(torch, kcache[key], dcache[key])[0]
            for key in kcache if key != "index"}
        del kcache, dcache, plain32
        out["bf16_floor"], _ = logits_gap(torch, dense, dense32)
        out["bf16_kernel_vs_f32"], _ = logits_gap(torch, logits, dense32)
        out["bf16_greedy_agree_kernel_vs_f32"] = greedy_agree(logits, dense32)
        del dense, dense32

        # (c) prefill all but the last token, decode it, against the
        # prefill of all.  With capacity-limited experts the two prefills
        # drop different assignments (the ranks run over the flattened
        # batch), so a moe model takes this check where nothing drops, on
        # a prompt short enough for that capacity's buffers.
        check_tokens, check_cfg = tokens, cfg
        if cfg.family == "moe":
            check_tokens = tokens[:, :MOE_CHECK_PROMPT]
            check_cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            out["decode_check"] = (
                f"{LM_BATCH} x {MOE_CHECK_PROMPT}-token prompt at capacity "
                f"factor {check_cfg.capacity_factor}, where no assignment "
                f"drops; its own bf16 floor")
        n_check = check_tokens.shape[1]
        for prec, act, mode, want in (
                ("bf16", torch.bfloat16, "kernel", logits),
                ("f32", torch.float32, f32_mode, kern32)):
            c = dataclasses.replace(check_cfg, act_dtype=act)
            cache_dtype = torch.float32 if prec == "f32" else None
            if check_tokens is not tokens:
                want = prefill_in(torch, T, mode, params, c, check_tokens,
                                  n_check, cache_dtype)[0]
            out[f"{prec}_decode_vs_prefill"] = decode_vs_prefill(
                torch, T, build(c), params, c, check_tokens, want,
                cache_dtype, mode, pos(0, n_check))
        check_floor = out["bf16_floor"]
        if check_tokens is not tokens:
            check_floor, _ = logits_gap(torch, *(prefill_in(
                torch, T, "dense", params, dataclasses.replace(
                    check_cfg, act_dtype=dt), check_tokens, n_check)[0]
                for dt in (torch.bfloat16, torch.float32)))
            out["bf16_floor_decode_check"] = check_floor
        del logits, kern32, params
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    bf16_tol = LM_BF16_FLOORS * min(out["bf16_floor"], TOL_LM_BF16_FLOOR)
    check(arch not in LM_FLOOR_HELD or out["bf16_floor"] <= TOL_LM_BF16_FLOOR,
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
    check(out["bf16_decode_vs_prefill"]["rel"]
          <= LM_BF16_FLOORS * min(check_floor, TOL_LM_BF16_FLOOR),
          f"lm_serve {arch}: bf16 prefill + decode vs prefill "
          f"{out['bf16_decode_vs_prefill']} > {LM_BF16_FLOORS} x "
          f"{check_floor}")
    return launches


def decode_vs_prefill(torch, T, bundle, params, cfg, tokens, want,
                      cache_dtype=None, mode="kernel", positions=None):
    """Check (c): prefill all but the last token (sites in ``mode``),
    decode the last one, and compare with ``want``, the logits of the
    prefill of all the tokens."""
    last = None if positions is None else positions[..., -1:]
    _, cache, _ = prefill_in(
        torch, T, mode, params, cfg, tokens[:, :-1], tokens.shape[1],
        cache_dtype, None if positions is None else positions[..., :-1])
    got, _ = bundle.serve_step(params, cache, tokens[:, -1:], last)
    rel_gap, excess = logits_gap(torch, got, want)
    return {"rel": rel_gap, "allclose_excess": excess}


def phase_lm_serve_encdec(torch, np, arch):
    """The encoder-decoder ``arch`` at full width and depth with bf16
    weights drawn on the card from SEED: encode LM_BATCH x enc_frames stub
    frame embeddings through the kernels, fill each decoder layer's cross
    K/V in a cache of ENC_CONTEXT positions, run the teacher-forced decoder
    over ENC_SEQ tokens, the same tokens as ENC_SEQ decode steps, then
    LM_DECODE greedy steps.  Checks (a) finite logits, (b) kernel vs plain
    (encoder and teacher-forced logits) and (c) decode steps against the
    teacher-forced logits, each in bf16 and in f32 (the same bf16 weights
    read by f32 activations), the bf16 bounds from the measured distance
    of the plain bf16 run from the plain f32 one.  Returns the flash
    kernel's launches of the served run."""
    import dataclasses
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import encdec as E
    from repro_torch.models.attention import cross_kv
    from repro_torch.models.common import take
    from repro_torch.models.model import build

    t_phase = time.perf_counter()
    cfg, reduced = lm_config(arch)
    per = encdec_launches(cfg)
    bundle = build(cfg)
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal(
        (LM_BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32)).cuda()
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(LM_BATCH, ENC_SEQ))).cuda()
    out = {"phase": "lm_serve", "arch": arch, "family": cfg.family,
           "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
           "reduced": reduced, "batch": LM_BATCH, "frames": cfg.enc_frames,
           "teacher_forced_tokens": ENC_SEQ, "decode_tokens": LM_DECODE,
           "cache_positions": ENC_CONTEXT}

    def run(mode, c, steps=0, cache_dtype=torch.bfloat16):
        """Encode, fill the cross K/V, decode_train, and ``steps``
        teacher-forced decode steps with every site in ``mode``; returns
        (dict of outputs and seconds, cache)."""
        with sites_in(mode):
            r, start = {}, flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["enc"] = E.encode(params, c, frames)
            torch.cuda.synchronize()
            r["encode_s"] = time.perf_counter() - t0
            r["encode_launches"] = flash_attention.launches - start
            cache = E.init_cache(c, LM_BATCH, ENC_CONTEXT, cache_dtype)
            for i in range(c.n_layers):
                cache["xk"][i], cache["xv"][i] = cross_kv(
                    r["enc"], take(params["dec"]["xattn"], i), c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["train"] = E.decode_train(params, c, tokens, r["enc"])
            torch.cuda.synchronize()
            r["decode_train_s"] = time.perf_counter() - t0
            r["decode_train_launches"] = (flash_attention.launches - start
                                          - r["encode_launches"])
            steps_out = []
            for t in range(steps):
                logits, cache = E.decode_step(params, c, cache,
                                              tokens[:, t:t + 1])
                steps_out.append(logits)
            if steps:
                r["steps"] = torch.stack(steps_out, dim=1)
            return r, cache

    with torch.no_grad():
        params = draw_params(torch, bundle, out)
        # a decode step reads the decoder's weights, the head and the cross
        # K/V
        out["decode_bound_ms"] = (
            weight_bytes(params, skip=("embed", "pos_dec", "enc", "enc_norm"))
            + 2 * cfg.n_layers * LM_BATCH * cfg.enc_frames * cfg.n_kv_heads
            * cfg.d_head * 2) / PEAK_BYTES * 1e3

        # the served run: every count starts at 0 and is read right after
        dispatch.reset_dispatch_stats()
        flash_attention.launches = 0
        served, cache = run("kernel", cfg, ENC_SEQ)
        tf_launches = flash_attention.launches
        finite = (torch.isfinite(served["train"]).all()
                  & torch.isfinite(served["steps"]).all())
        tok = served["steps"][:, -1].argmax(dim=-1, keepdim=True)
        generated = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sites_in("kernel"):
            for _ in range(LM_DECODE):
                step_logits, cache = bundle.serve_step(params, cache, tok)
                finite &= torch.isfinite(step_logits).all()
                tok = step_logits.argmax(dim=-1, keepdim=True)
                generated.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        counters = attention_counters(dispatch)
        launches = {"flash_attention": flash_attention.launches,
                    "ssd_scan": 0}
        got = {"encode": served["encode_launches"],
               "decode_train": served["decode_train_launches"],
               "decode_step": (flash_attention.launches - tf_launches)
               / LM_DECODE,
               "teacher_forced_decode_step": (
                   tf_launches - served["encode_launches"]
                   - served["decode_train_launches"]) / ENC_SEQ}
        out.update(
            encode_s=served["encode_s"],
            encode_frames_per_s=LM_BATCH * cfg.enc_frames / served["encode_s"],
            decode_train_s=served["decode_train_s"],
            decode_ms_per_token=decode_s / LM_DECODE * 1e3,
            decode_tokens_per_s=LM_BATCH * LM_DECODE / decode_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches_per=got, launches=launches, counters=counters,
            generated=torch.cat(generated, dim=1)[:, :8].tolist())
        want_per = dict(per, teacher_forced_decode_step=per["decode_step"])
        check(bool(finite),
              f"lm_serve {arch}: non-finite logits in decode_train or decode")
        check(got == want_per,
              f"lm_serve {arch}: flash launches {got}, expected {want_per}")
        check(counters["kernel_attention_calls"] == launches["flash_attention"]
              and counters["dense_attention_calls"] == 0,
              f"lm_serve {arch}: dispatch counters {counters}")
        del cache

        # one profiled encode, then the cross K/V fill (no flash launch)
        # that a served request runs next
        def encode_and_cross_kv():
            enc = E.encode(params, cfg, frames)
            for i in range(cfg.n_layers):
                cross_kv(enc, take(params["dec"]["xattn"], i), cfg)

        with sites_in("kernel"):
            kernels, wall, trace, _ = traced(torch, encode_and_cross_kv,
                                       f"lm_profile {arch} encode")
        prof_line = {"phase": "lm_profile", "arch": arch,
                     "what": f"one kernel-mode encode, {LM_BATCH} x "
                     f"{cfg.enc_frames} frames, and the cross K/V of its "
                     f"{cfg.n_layers} decoder layers, bf16", **trace,
                     **device_profile(kernels, wall, focus=("flash_",))}
        prof_line["flash_device_ms"] = sum(
            r["device_ms"] for r in prof_line["focus"] if "flash_" in r["name"])
        emit(prof_line)
        calls = sum(r["calls"] for r in prof_line["focus"]
                    if FLASH_BF16_KERNEL in r["name"])
        check(calls == per["encode"],
              f"lm_profile {arch}: {FLASH_BF16_KERNEL} ran {calls} times in "
              f"an encode, not {per['encode']}")

        # (b) and (c) in bf16, f32 and the floor: the plain versions, and
        # the same bf16 weights read by f32 activations
        cfg32 = dataclasses.replace(cfg, act_dtype=torch.float32)
        out["f32_weights"] = "the bf16 weights, read by f32 activations"
        dense, _ = run("dense", cfg)
        kern32, _ = run("kernel", cfg32, ENC_SEQ, torch.float32)
        dense32, _ = run("dense", cfg32)
        for prec, k, d in (("bf16", served, dense), ("f32", kern32, dense32)):
            out[f"{prec}_kernel_vs_dense"], _ = logits_gap(
                torch, k["train"], d["train"])
            out[f"{prec}_encoder_kernel_vs_dense"], _ = logits_gap(
                torch, k["enc"], d["enc"])
            out[f"{prec}_greedy_agree_kernel_vs_dense"] = greedy_agree(
                k["train"].flatten(0, 1), d["train"].flatten(0, 1))
            gap, excess = logits_gap(torch, k["steps"], k["train"])
            out[f"{prec}_decode_vs_decode_train"] = {
                "rel": gap, "allclose_excess": excess}
        out["bf16_floor"], _ = logits_gap(torch, dense["train"],
                                          dense32["train"])
        del served, dense, kern32, dense32, params
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    bf16_tol = LM_BF16_FLOORS * min(out["bf16_floor"], TOL_LM_BF16_FLOOR)
    check(out["f32_kernel_vs_dense"] <= TOL_LM_F32
          and out["f32_encoder_kernel_vs_dense"] <= TOL_LM_F32,
          f"lm_serve {arch}: f32 kernel vs plain {out['f32_kernel_vs_dense']}"
          f" (encoder {out['f32_encoder_kernel_vs_dense']})")
    check(out["bf16_kernel_vs_dense"] <= bf16_tol,
          f"lm_serve {arch}: bf16 kernel vs plain logits "
          f"{out['bf16_kernel_vs_dense']} > {bf16_tol}")
    check(out["f32_decode_vs_decode_train"]["allclose_excess"] <= 0,
          f"lm_serve {arch}: f32 decode steps vs decode_train "
          f"{out['f32_decode_vs_decode_train']}")
    check(out["bf16_decode_vs_decode_train"]["rel"] <= bf16_tol,
          f"lm_serve {arch}: bf16 decode steps vs decode_train "
          f"{out['bf16_decode_vs_decode_train']} > {bf16_tol}")
    return launches


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
    kernels, prof_wall, trace, _ = traced(torch, value_and_grad,
                                    "vqe value-and-grad")
    profiled = {**trace, **device_profile(kernels, prof_wall)}
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


def bf16_instantiations(kernels):
    """Calls of the bf16 instantiations of the Gram and tall-apply tile
    kernels in device time by kernel (``kernels``, as :func:`traced`
    returns them; demangled or mangled names)."""
    patterns = {
        "gram_tile_kernel<complex,bf16>":
            r"gram_tile_kernel(<true, true>|ILb1ELb1E)",
        "tall_apply_kernel<complex,bf16,·>":
            r"tall_apply_kernel(<true, true, (true|false)>|ILb1ELb1ELb[01]E)",
    }
    return {name: sum(count for key, (count, _) in kernels.items()
                      if re.search(pattern, key))
            for name, pattern in patterns.items()}


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
    # one kernel-lane case again under the profiler, CUDA activity alone
    # (its trace of a whole full-update step takes a minute to collect)
    prev = dispatch.set_kernel_backend("kernel")
    try:
        kernels, _, trace, _ = traced(
            torch, lambda: cases["contract_twolayer"]("mixed", True),
            "robustness precision_profile", cpu=False)
    finally:
        dispatch.set_kernel_backend(prev)
    prof_counts = bf16_instantiations(kernels)
    emit({"phase": "robustness", "part": "precision_profile",
          "what": "contract_twolayer, mixed, kernel mode", **trace,
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


# ---------------------------------------------------------------------------
# LM training (train phase)
# ---------------------------------------------------------------------------

def train_launcher(torch, batch):
    """TRAIN_STEPS steps of ``repro_torch.launch.train.main`` on
    TRAIN_ARCH at ``batch`` x TRAIN_SEQ tokens; (params after the last
    step, the launcher's step records, the dispatch counters, the flash
    kernel's launches, the peak memory, the seconds of ``main``)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as L

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--batch", str(batch), "--seq", str(TRAIN_SEQ),
            "--lr", str(TRAIN_LR), "--seed", str(SEED), "--device", "cuda"]
    with tempfile.TemporaryDirectory() as d:
        log = os.path.join(d, "train.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_dispatch_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        params = L.main(argv + ["--log-file", log])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(log) as f:
            recs = [json.loads(line) for line in f]
    return (params, recs, attention_counters(dispatch),
            flash_attention.launches, torch.cuda.max_memory_allocated(),
            seconds)


def plain_attention_ms(prof) -> float:
    """Device ms of PLAIN_ATTENTION_OPS in a profile (each op's own
    kernels and those of the ops it calls)."""
    total = 0.0
    for evt in prof.key_averages():
        if evt.key in PLAIN_ATTENTION_OPS:
            us = getattr(evt, "device_time_total", None)
            total += (evt.cuda_time_total if us is None else us) / 1e3
    return total


def train_qwen(torch, np):
    """Qwen3-4B trained by the launcher, then, on step 1's batch with the
    trained weights, the validation loss through the flash kernel and
    through the plain versions, and one profiled step.  Returns the
    validation loss's kernel launches."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import step_batch
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import adamw_init

    cfg = get(TRAIN_ARCH)
    out = {"phase": "train", "part": "launcher", "arch": TRAIN_ARCH,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab,
           "param_dtype": str(cfg.param_dtype).replace("torch.", ""),
           "moments": "float32", "remat": cfg.remat,
           "remat_policy": cfg.remat_policy, "microbatches": 1,
           "lr": TRAIN_LR,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "reduced": {}}
    batch, run = TRAIN_BATCH, None
    try:
        run = train_launcher(torch, batch)
    except torch.cuda.OutOfMemoryError as e:
        out["batch_oom"] = str(e)[:300]
    if run is None:
        # out of the handler, so the failed run's frames are gone
        gc.collect()
        torch.cuda.empty_cache()
        batch = TRAIN_BATCH_CUT
        out["reduced"]["batch"] = [TRAIN_BATCH, batch]
        run = train_launcher(torch, batch)
    params, recs, counters, launches, peak, main_s = run
    tokens = batch * TRAIN_SEQ
    n_params = sum(t.numel() for t in _leaves_of(params))
    step_s = [r["sec"] for r in recs]
    median = statistics.median(step_s[1:])
    bound_s = 6 * n_params * tokens / PEAK_BF16_TC_FLOPS
    out.update(batch=batch, tokens_per_step=tokens, params=n_params,
               main_s=main_s, s_per_step=median, step1_s=step_s[0],
               step_s=step_s, tokens_per_s=tokens / median,
               bound_s=bound_s, bound="6 x params x tokens FLOPs at "
               "989 TFLOP/s bf16", share_of_bound=bound_s / median,
               max_memory_allocated=peak,
               losses=[r["loss"] for r in recs],
               grad_norms=[r["grad_norm"] for r in recs],
               counters=counters, flash_launches=launches,
               nvidia_smi=nvidia_smi_line())
    emit(out)
    per_step = 2 * cfg.n_layers          # the forward and the recompute
    check(len(recs) == TRAIN_STEPS and all(
        math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
        for r in recs), f"train: step records {recs}")
    check(counters["dense_attention_grad_calls"] == per_step * TRAIN_STEPS
          and counters["kernel_attention_calls"] == 0 and launches == 0,
          f"train: {TRAIN_STEPS} steps ran the attention site {counters} "
          f"and the flash kernel {launches} times; expected "
          f"{per_step} differentiated dense calls a step, no kernel")

    # validation loss on step 1's batch with the trained weights: through
    # the flash kernel, through the plain versions, and (the loss's own
    # bf16 floor) the plain versions with f32 activations on the same
    # bf16 weights
    bundle = build(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=batch, seed=SEED))
    vbatch = step_batch(cfg, data, 0, torch.device("cuda"))
    val = {"phase": "train", "part": "validation", "arch": TRAIN_ARCH,
           "batch": batch, "what": "loss_fn under no_grad on step 1's "
           f"batch after {TRAIN_STEPS} steps"}
    with torch.no_grad():
        dispatch.reset_dispatch_stats()
        flash_attention.launches = 0
        with sites_in("kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_k = bundle.loss_fn(params, vbatch).item()
            val["kernel_s"] = time.perf_counter() - t0
        val_launches = {"flash_attention": flash_attention.launches}
        val["counters"] = attention_counters(dispatch)
        with sites_in("dense"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_d = bundle.loss_fn(params, vbatch).item()
            val["dense_s"] = time.perf_counter() - t0
            cfg32 = dataclasses.replace(cfg, act_dtype=torch.float32)
            loss_32 = build(cfg32).loss_fn(params, vbatch).item()
    floor = abs(loss_d - loss_32) / abs(loss_32)
    gap = abs(loss_k - loss_d) / abs(loss_d)
    val.update(loss_kernel=loss_k, loss_dense=loss_d, loss_f32=loss_32,
               launches=val_launches, kernel_vs_dense=gap, bf16_floor=floor,
               bound=LM_BF16_FLOORS * floor,
               bound_reason="each bf16 loss lies about one bf16 floor (the "
               "plain loss against the same bf16 weights read by f32 "
               "activations) from the f32 loss, so the two bf16 losses "
               "differ by at most twice it, as lm_serve bounds logits")
    emit(val)
    check(val_launches["flash_attention"] == cfg.n_layers
          and val["counters"]["kernel_attention_calls"] == cfg.n_layers,
          f"train validation: flash launches {val_launches}, counters "
          f"{val['counters']}, expected {cfg.n_layers}")
    check(all(map(math.isfinite, (loss_k, loss_d, loss_32)))
          and gap <= LM_BF16_FLOORS * floor,
          f"train validation: kernel loss {loss_k} vs dense {loss_d}: "
          f"{gap} > {LM_BF16_FLOORS} x floor {floor}")

    # one profiled step (the trained weights and fresh moments)
    opt = adamw_init(params)
    kernels, wall, trace, prof = traced(
        torch, lambda: bundle.train_step(params, opt, vbatch, donate=True),
        "train profile")
    line = {"phase": "train_profile", "arch": TRAIN_ARCH,
            "what": f"one training step, {batch} x {TRAIN_SEQ} tokens, bf16, "
            "remat nothing", **trace,
            **device_profile(kernels, wall, focus=("softmax", "masked_fill"))}
    line["plain_attention_ops"] = list(PLAIN_ATTENTION_OPS)
    line["plain_attention_device_ms"] = plain_attention_ms(prof)
    line["plain_attention_share"] = (line["plain_attention_device_ms"] / 1e3
                                     / max(line["device_s"], 1e-9))
    emit(line)
    del params, opt, prof
    torch.cuda.empty_cache()
    return val_launches


def _leaves_of(tree):
    from repro_torch.models.common import tree_leaves
    return [t for _, t in tree_leaves(tree)]


@contextlib.contextmanager
def moe_slots(record=None, replay=None, differences=None):
    """Every ``moe._route`` call made inside appends its ``Route`` to
    ``record``; with ``replay`` (an earlier run's record, on any device),
    each call keeps its live routing weights, which carry the router's
    gradient, and takes that run's slots (expert, slot, kept), moved to its
    device: the earlier run's expert choices, pinned.  ``differences``
    collects, per call, the assignments whose live slots differ."""
    from repro_torch.models import moe
    route, pinned = moe._route, None if replay is None else iter(replay)

    def hooked(*args, **kwargs):
        r = route(*args, **kwargs)
        if pinned is not None:
            p = next(pinned)
            e, c, keep = (t.to(r.slot_e.device)
                          for t in (p.slot_e, p.slot_c, p.keep))
            if differences is not None:
                differences.append(int(((e != r.slot_e)
                                        | (c != r.slot_c)).sum()))
            r = r._replace(slot_e=e, slot_c=c, keep=keep)
        if record is not None:
            record.append(r)
        return r

    moe._route = hooked
    try:
        yield
    finally:
        moe._route = route


def train_families(torch, np):
    """One f32 step of each architecture's smoke config on the card and on
    the CPU, from the same weights and batch: the loss and every gradient
    leaf held card against CPU."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import step_batch
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import adamw_init

    rows = {}
    for arch in configs.ARCHS:
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  param_dtype=torch.float32,
                                  act_dtype=torch.float32)
        bundle = build(cfg)
        weights = lm_params_to_numpy(bundle.init(SEED, "cpu"))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SMOKE_SEQ,
                                      global_batch=2, seed=SEED))
        got, routes, diffs = {}, [], []
        for dev in ("cpu", "cuda"):
            params = lm_params_from_numpy(weights, device=dev)
            batch = step_batch(cfg, data, 0, torch.device(dev))
            with moe_slots(record=routes if dev == "cpu" else None,
                           replay=routes if dev == "cuda" else None,
                           differences=diffs):
                loss, grads = bundle.value_and_grad(params, batch)
                _, _, metrics = bundle.train_step(params, adamw_init(params),
                                                  batch)
            got[dev] = (loss.item(), {p: g.cpu() for p, g in
                                      tree_leaves(grads)},
                        metrics["loss"].item())
        (loss_c, grads_c, step_c), (loss_g, grads_g, step_g) = (
            got["cpu"], got["cuda"])
        grad_gaps = {"/".join(p): rel_gap(torch, grads_g[p], grads_c[p])
                     for p in grads_c}
        row = {"loss_gap": abs(loss_g - loss_c) / abs(loss_c),
               "step_loss_gap": abs(step_g - step_c) / abs(step_c),
               "grad_gap_max": max(grad_gaps.values()),
               "grad_leaves": len(grad_gaps)}
        if cfg.family == "moe":
            row["routes"] = ("pinned to the CPU run's slots (expert, slot, "
                             "kept) as lm_serve pins them; routing weights "
                             "live")
            row["live_slot_differences"] = sum(diffs)
        rows[arch] = row
        check(row["loss_gap"] <= TOL_TRAIN_LOSS
              and row["step_loss_gap"] <= TOL_TRAIN_LOSS
              and row["grad_gap_max"] <= TOL_TRAIN_GRAD,
              f"train families {arch}: card vs CPU {row}, worst leaf "
              f"{max(grad_gaps, key=grad_gaps.get)}")
    emit({"phase": "train", "part": "families", "what": "one f32 step of "
          "each smoke config, card vs CPU", "tol_loss": TOL_TRAIN_LOSS,
          "tol_grad": TOL_TRAIN_GRAD, "archs": rows})


def train_chaos(torch):
    """The launcher killed with os._exit(42) after step TRAIN_CHAOS_KILL
    and resumed, in subprocesses on the card: the overlapping losses equal
    the uninterrupted run's bit for bit."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + ([os.environ["PYTHONPATH"]] if "PYTHONPATH" in os.environ
                 else [])))

    def run(args, rc=0):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CHAOS,
             "--device", "cuda", *args], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        check(res.returncode == rc, f"train chaos {args}: exit "
              f"{res.returncode}, expected {rc}: {res.stderr[-1500:]}")
        return res

    def losses(path, runs):
        out = {}
        with open(path) as f:
            for rec in map(json.loads, f):
                runs.append(out.get(rec["step"], rec["loss"]) == rec["loss"])
                out[rec["step"]] = rec["loss"]
        return out

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        a, b, ck = (os.path.join(d, n) for n in ("a.jsonl", "b.jsonl", "ck"))
        run(["--log-file", a])
        run(["--checkpoint-dir", ck, "--log-file", b, "--simulate-failure",
             str(TRAIN_CHAOS_KILL)], rc=42)
        resumed = run(["--checkpoint-dir", ck, "--log-file", b])
        repeats = []
        ref, got = losses(a, []), losses(b, repeats)
    line = {"phase": "train", "part": "chaos", "argv": list(TRAIN_CHAOS),
            "killed_after_step": TRAIN_CHAOS_KILL,
            "resumed": "resuming from checkpoint step 10" in resumed.stdout,
            "steps": len(got), "bitwise": got == ref,
            "repeated_steps_bitwise": all(repeats),
            "losses_first_last": [ref.get(0), ref.get(15)],
            "seconds": time.perf_counter() - t0}
    emit(line)
    check(line["resumed"] and line["bitwise"] and all(repeats)
          and len(got) == 16, f"train chaos: {line}")


def phase_train(torch, np):
    """LM training on the card: Qwen3-4B through the launcher, its
    validation loss through the flash kernel and one profiled step; every
    architecture's smoke step against the CPU; the launcher's chaos kill
    and resume.  Returns the flash kernel's launches (the validation
    loss's)."""
    launches = train_qwen(torch, np)
    train_families(torch, np)
    train_chaos(torch)
    return launches


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
          "no_spill_ptxas": no_spill,
          "profiler_warm": warm_profiler(torch)})

    phase_s = {"build": build_s}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    only = sys.argv[1:]
    if only:
        # a partial run of phases that need no other phase's state; it
        # prints no result line
        standalone = {"kernels": (phase_kernels, torch),
                      "wrappers": (phase_wrappers, torch),
                      "lm_kernels": (phase_lm_kernels, torch),
                      "ite": (phase_ite, torch, np),
                      "vqe": (phase_vqe, torch, np),
                      "train": (phase_train, torch, np)}
        unknown = [name for name in only if name not in standalone]
        if unknown:
            print(f"chip_smoke: unknown phases {unknown}; standalone "
                  f"phases: {sorted(standalone)}", file=sys.stderr)
            return 2
        try:
            for name in only:
                timed(name, *standalone[name])
        except CheckFailed as e:
            print(f"chip_smoke: check failed: {e}", file=sys.stderr)
            return 1
        emit({"phase": "done", "partial": only, "phase_seconds": phase_s,
              "seconds": time.perf_counter() - t_start})
        return 0

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
        serving, serving_summary = timed("serving", phase_serving, torch, np,
                                         state, main_info)
        del state
        torch.cuda.empty_cache()
        by_path = {"peps": dict(launches), "serving": serving,
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
        by_path[ENCDEC_ARCH] = timed(f"lm_serve_{ENCDEC_ARCH}",
                                     phase_lm_serve_encdec, torch, np,
                                     ENCDEC_ARCH)
        torch.cuda.empty_cache()
        by_path["train"] = timed("train", phase_train, torch, np)
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
          "phase_seconds": phase_s, "serving": serving_summary,
          "vqe": vqe_summary, "robustness": robustness_summary})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
