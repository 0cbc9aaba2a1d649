#!/usr/bin/env python3
"""Time variants of the tiled GEMM kernel on the card.

    PYTHONPATH=src python3 tools/tiled_matmul_variants.py [name ...]

Each variant is ``src/repro_torch/kernels/csrc/tiled_matmul.cu`` with a few
text substitutions (``VARIANTS``), built by its own ``nvcc`` (all started
together) into the git-ignored ``src/repro_torch/kernels/_build/variants/``.
Each is timed at ``SHAPES`` in turns with the committed source and
``torch.matmul``: warm (CUDA events around 20 back-to-back launches that
the host queued behind a ``torch.cuda._sleep``, so that the device time is
read, not the host's; median of 7) and cold (one launch after 128 MB were
written to evict the L2, median of 21), and the device time of each of
its kernels (``torch.profiler``, mean of 20 back-to-back calls).  Variants
that are not marked as diagnostics are held against ``tiled_matmul_plain``
at 1e-5; diagnostics skip work and are wrong by design.  Prints one JSON
line per variant and shape, and the card's ``nvidia-smi`` line.
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
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build
from repro_torch.kernels import tiled_matmul as KT

OUT = build.BUILD_ROOT / "variants"
# (M, K, N, A transposed)
SHAPES = [(72, 82944, 72, True), (200, 3000, 130, False)]
FLUSH_BYTES = 128 * 2**20
SLEEP_CYCLES = 4_000_000      # about 2 ms: the host queues the loop behind it

_NO_LOAD = ("if (s + STAGES - 1 < nst) fetch(s + STAGES - 1);",
            "if (false) fetch(s + STAGES - 1);")
_NO_FMA = ("row_fma<TRANS>(as, bs, r, ti, tj, acc);", "(void)r;")
_NO_LDS = [("lds<TM>(as + r * BT + ti * TM, av);",
            "lds<TM>(as + ti * TM, av);"),
           ("lds<TN>(bs + r * BT + tj * TN, bv);",
            "lds<TN>(bs + tj * TN, bv);")]

_STAGES = "constexpr int STAGES = 4;"
_NO_BULK = ("const int bulk = TRANS && m == BT && n == BT && vec_a && vec_b;",
            "const int bulk = 0;")

# name: ([(old, new), ...], diagnostic)
VARIANTS = {
    "committed": ([], False),
    # the per-thread cp.async ring at the main shape too
    "no_bulk": ([_NO_BULK], False),
    # 3 groups, 432 threads; 6 x 12 thread tiles (72 accumulators, 4 FMAs
    # a shared-memory word) in 4 groups, 288 threads
    "g3": ([("constexpr int GROUPS = 4;", "constexpr int GROUPS = 3;")],
           False),
    "tile6x12": ([("constexpr int TN = 6;", "constexpr int TN = 12;")], False),
    # a shallower ring
    "stages3": ([(_STAGES, "constexpr int STAGES = 3;")], False),
    # diagnostics: the FMAs with each thread's operands read from one K-row
    # (loop-invariant shared-memory loads) and no ring loads after its
    # first fill; the loads without the FMAs; neither (the launch, the
    # fill, the groups' sums and the partials).  Those that skip loads run
    # the cp.async path, whose waits do not need them.
    "no_load_no_lds": ([_NO_BULK, _NO_LOAD] + _NO_LDS, True),
    "no_fma": ([_NO_FMA], True),
    "no_work": ([_NO_BULK, _NO_LOAD, _NO_FMA], True),
}


def build_variants(names):
    src = (build.CSRC / "tiled_matmul.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = OUT / f"tmm_{name}.cu"
        cu.write_text(text)
        lib = OUT / f"libtmm_{name}.so"
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
                          "spills": spills, "sass": sass_histogram(lib)}),
              flush=True)
        cdll = ctypes.CDLL(str(lib))
        for fn in ("repro_tiled_matmul_f32", "repro_tiled_matmul_splits"):
            getattr(cdll, fn).argtypes = list(build._SIGNATURES[fn])
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def runner(lib, a, b):
    """A zero-argument launch of ``lib``'s kernel on (a, b), its output and
    scratch allocated once."""
    m, k = a.shape
    n = b.shape[1]
    trans = not a.is_contiguous()
    sms = build.sm_count(a.device)
    splits = lib.repro_tiled_matmul_splits(m, k, n, sms)
    c = torch.empty((m, n), device=a.device)
    work = torch.empty((splits, m, n), device=a.device) if splits > 1 else c
    stream = build.stream_ptr(a.device)

    def run():
        build.check(lib.repro_tiled_matmul_f32(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), work.data_ptr(), m, k,
            n, int(trans), sms, 0, stream), "tiled_matmul variant")
        return c
    return run


def time_warm_ms(fn, reps=7, inner=20):
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        vals.append(start.elapsed_time(end) / inner)
    return statistics.median(vals)


def time_cold_ms(fn, flush, reps=21):
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
        end.synchronize()
        vals.append(start.elapsed_time(end))
    return statistics.median(vals)


def sass_histogram(lib, kernel="tiled_matmul_kernelILb1ELb0E"):
    """Opcode counts of one kernel's SASS (A transposed, f32): the whole
    kernel, and its longest straight run between branches and barriers
    (the unrolled FMA loop)."""
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


def kernel_ms(fn, calls=20):
    """Mean device ms per call of each kernel ``fn`` launches
    (``torch.profiler``)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0)
        if us and str(evt.device_type).endswith("CUDA"):
            name = evt.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1].split("<")[0]
            out[name[:60]] = out.get(name[:60], 0.0) + us / calls / 1e3
    return out


def main(names):
    if not torch.cuda.is_available():
        print("tiled_matmul_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = ["committed"] + [n for n in (names or VARIANTS)
                             if n != "committed"]
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for m, k, n, trans in SHAPES:
        a = (torch.randn((k, m), generator=gen, device="cuda").T if trans
             else torch.randn((m, k), generator=gen, device="cuda"))
        b = torch.randn((k, n), generator=gen, device="cuda")
        plain = KT.tiled_matmul_plain(a, b)
        runs = {name: runner(libs[name], a, b) for name in names}
        runs["matmul"] = lambda a=a, b=b: torch.matmul(a, b)
        if trans:
            print(json.dumps({"clocks_under_load": clocks_under_load(
                runs["committed"])}), flush=True)
        # in turns: committed, each variant, matmul, committed again
        order = ["committed"] + [x for x in names if x != "committed"] + \
            ["matmul", "committed"]
        warm, cold = {}, {}
        for name in order:
            warm.setdefault(name, []).append(time_warm_ms(runs[name]))
            cold.setdefault(name, []).append(time_cold_ms(runs[name], flush))
        for name in names + ["matmul"]:
            got = runs[name]()
            err = ((torch.linalg.norm(got - plain) / torch.linalg.norm(plain))
                   .item())
            if name in VARIANTS and not VARIANTS[name][1] and not err <= 1e-5:
                raise SystemExit(f"variant {name} {[m, k, n]}: rel err {err}")
            print(json.dumps({"variant": name, "shape": [m, k, n],
                              "a_transposed": trans, "warm_ms": warm[name],
                              "cold_ms": cold[name],
                              "kernels_ms": kernel_ms(runs[name]),
                              "rel_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
