#!/usr/bin/env python3
"""Time variants of the tall-apply kernel on the card.

    PYTHONPATH=src python3 tools/tall_apply_variants.py [name ...]

Each variant is ``src/repro_torch/kernels/csrc/tall_apply.cu`` with a few
text substitutions (``VARIANTS``), built by its own ``nvcc`` (all started
together) into the git-ignored ``src/repro_torch/kernels/_build/variants/``.
Each is timed at the main path's complex64 shapes and the real (82,944 x
144 x 144) against the committed source, in turns (CUDA events, median of
7 x 20 calls, warm L2), and held against the plain versions, except the
variants marked as diagnostics, whose results are wrong by design.  Prints
one JSON line per variant and shape, and the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import matvec as KM

OUT = build.BUILD_ROOT / "variants"
SHAPES = [(82944, 72, 72), (82944, 72, 64), (46656, 72, 72),
          (82944, 36, 36), (2304, 72, 72), (1296, 72, 72)]
REAL_SHAPE = (82944, 144, 144)

_A_LOAD = ("      av[r] = *reinterpret_cast<const float4*>(as + r * RG * PA"
           " + 4 * p);\n#pragma unroll\n    for (int h = 0; h < 2; ++h) {")
_B_LOAD = "bs + (2 * p + h) * NBF)[cg + CG * q];"
_NO_LOAD = ("if (s + STAGES - 1 < nstage) fetch(s + STAGES - 1);",
            "if (false) fetch(s + STAGES - 1);")
_SCALAR = ("const bool vec_out = nf % 4 == 0;", "const bool vec_out = false;")

# name: ([(old, new), ...], diagnostic)
VARIANTS = {
    "committed": ([], False),
    # the ring, the slab depth, the block and thread tiles
    "stages4": ([("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
                False),
    "sk16": ([("constexpr int SK = 24;", "constexpr int SK = 16;")], False),
    "sk48": ([("constexpr int SK = 24;", "constexpr int SK = 48;")], False),
    "sk16_stages4": ([("constexpr int SK = 24;", "constexpr int SK = 16;"),
                      ("constexpr int STAGES = 3;",
                       "constexpr int STAGES = 4;")], False),
    "rg16_2blk": ([("constexpr int RG = 32;", "constexpr int RG = 16;"),
                   ("constexpr int MIN_BLOCKS = 1;",
                    "constexpr int MIN_BLOCKS = 2;")], False),
    "rg48_r4": ([("constexpr int RG = 32;", "constexpr int RG = 48;"),
                 ("constexpr int RMAX = 6;", "constexpr int RMAX = 4;")],
                False),
    "rg64_r3": ([("constexpr int RG = 32;", "constexpr int RG = 64;"),
                 ("constexpr int RMAX = 6;", "constexpr int RMAX = 3;")],
                False),
    # the complex FMAs with the column loop outside the row loop
    "j_outer": ([("""      for (int r = 0; r < R; ++r) {
        const float ar = h ? av[r].z : av[r].x;
        const float ai = h ? av[r].w : av[r].y;
#pragma unroll
        for (int j = 0; j < CW / 2; ++j) {""", """      for (int j = 0; j < CW / 2; ++j) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
        const float ar = h ? av[r].z : av[r].x;
        const float ai = h ? av[r].w : av[r].y;""")], False),
    # C stored one float at a time: the accumulators need not sit in the
    # aligned register quads a 16-byte store reads
    "scalar_store": ([_SCALAR], False),
    # diagnostics: no FMAs (the loads, the ring and the stores alone); no
    # loads after the ring's first fill (the FMA stream on stale data), also
    # with scalar stores; the FMAs on operands loaded once a slab (the
    # shared-memory loads' share of the FMA loop)
    "no_fma": ([("float (&acc)[RMAX][CW]) {\n",
                 "float (&acc)[RMAX][CW]) {\n  return;\n")], True),
    "no_load": ([_NO_LOAD], True),
    "no_load_scalar_store": ([_NO_LOAD, _SCALAR], True),
    # the real FMAs on the neighbouring column's B value (wrong by design):
    # the accumulator and the B value then sit in registers of opposite
    # parity, which a register-bank conflict would show
    "no_load_real_swap": ([_NO_LOAD,
                           ("fmaf(x, bv[j], acc[r][j])",
                            "fmaf(x, bv[j ^ 1], acc[r][j])")], True),
    "no_lds": ([(_A_LOAD, _A_LOAD.replace(" + 4 * p)", ")")),
                (_B_LOAD, _B_LOAD.replace("(2 * p + h)", "h"))], True),
}


def build_variants(names):
    src = (build.CSRC / "tall_apply.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        lib = OUT / f"lib{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o",
               str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        spills = sorted(set(ln.strip() for ln in log.splitlines()
                            if "spill" in ln and " 0 bytes spill" not in ln))
        regs = sorted(set(int(w) for ln in log.splitlines() if "Used" in ln
                          for w in [ln.split("Used")[1].split()[0]]))
        print(json.dumps({"variant": name, "registers": regs,
                          "spills": spills}), flush=True)
        print(json.dumps({"variant": name, "sass": sass_histogram(lib)}),
              flush=True)
        cdll = ctypes.CDLL(str(lib))
        for fn in ("repro_tall_apply_f32", "repro_tall_apply_c64"):
            getattr(cdll, fn).argtypes = list(build._SIGNATURES[fn])
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def sass_histogram(lib, kernel="tall_apply_kernelILb1ELb0ELb0E"):
    """Opcode counts of one kernel's SASS (complex, f32, B as it is): the
    whole kernel, and its longest straight run between branches and
    barriers (the unrolled FMA loop of a full pass)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    ops, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside and "/*" in ln and ";" in ln:
            words = ln.split("*/", 1)[1].strip().split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ops.append(words[0].split(".")[0])
    runs, run = [], []
    for op in ops:
        if op in ("BRA", "BAR", "EXIT", "BSSY", "BSYNC", "WARPSYNC"):
            runs.append(run)
            run = []
        else:
            run.append(op)
    runs.append(run)

    def counts(seq):
        c = {}
        for op in seq:
            c[op] = c.get(op, 0) + 1
        return dict(sorted(c.items(), key=lambda kv: -kv[1])[:8])
    hot = max(runs, key=len)
    return {"kernel": counts(ops), "longest_run": len(hot),
            "longest_run_ops": counts(hot)}


def clocks_under_load(fn, seconds=3.0):
    """nvidia-smi's SM clock and power, sampled while ``fn`` runs back to
    back for about ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "250"], stdout=subprocess.PIPE,
        text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate()
    return [ln.strip() for ln in out.splitlines() if ln.strip()][2:-1]


def run(lib, a, b):
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), m, k, n, a.stride(0),
            *b.stride(), build.sm_count(a.device), 0)
    if a.is_complex():
        err = lib.repro_tall_apply_c64(*args, 0, 0, build.stream_ptr(a.device))
    else:
        err = lib.repro_tall_apply_f32(*args, build.stream_ptr(a.device))
    build.check(err, "tall_apply variant")
    return c


def time_ms(fn, reps=7, inner=20):
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


def main(names):
    if not torch.cuda.is_available():
        print("tall_apply_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = ["committed"] + [n for n in (names or VARIANTS)
                             if n != "committed"]
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = [(torch.complex(randn(m, k), randn(m, k)),
              torch.complex(randn(k, n), randn(k, n))) for m, k, n in SHAPES]
    cases.append((randn(*REAL_SHAPE[:2]), randn(*REAL_SHAPE[1:])))
    a, b = cases[0]
    print(json.dumps({"clocks_under_load": clocks_under_load(
        lambda: run(libs["committed"], a, b))}), flush=True)
    for a, b in cases:
        plain = (KM.tall_apply_complex_plain(a, b) if a.is_complex()
                 else KM.tall_apply_plain(a, b))
        # in turns: committed, each variant, committed again
        order = ["committed"] + [n for n in names if n != "committed"] + \
            ["committed"]
        times = {}
        for name in order:
            times.setdefault(name, []).append(
                time_ms(lambda lib=libs[name]: run(lib, a, b)))
        for name in names:
            got = run(libs[name], a, b)
            err = ((torch.linalg.norm(got - plain) / torch.linalg.norm(plain))
                   .item())
            if not VARIANTS[name][1] and not err <= 1e-5:
                raise SystemExit(f"variant {name} {tuple(a.shape)}: rel err "
                                 f"{err}")
            print(json.dumps({"variant": name,
                              "shape": [*a.shape, b.shape[1]],
                              "dtype": str(a.dtype).replace("torch.", ""),
                              "ms": times[name], "rel_err": err,
                              "matmul_ms": time_ms(lambda: a @ b)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
