#!/usr/bin/env python3
"""Time variants of the bf16 SSD scan kernels on the card.

    PYTHONPATH=src python3 tools/ssd_variants.py [name ...]

Each variant is ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with a few
text substitutions (``VARIANTS``), built by its own ``nvcc`` (all started
together) into the git-ignored ``src/repro_torch/kernels/_build/variants/``.
Each is timed at the served Zamba2 shape (320, 2048, 64, 64) and at
mamba2-2.7b's state (320, 2048, 64, 128), bf16, chunk 128, in turns with
the committed source: the whole call (CUDA events, median of 7 x 10 calls,
warm L2) and each of its kernels (``torch.profiler``, mean of 10 calls).  Variants that are not marked as diagnostics are held against
``ssd_scan_plain``; diagnostics skip work and are wrong by design.  Prints
one JSON line per variant and shape, and the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as KS

OUT = build.BUILD_ROOT / "variants"
SHAPES = [(320, 2048, 64, 64), (320, 2048, 64, 128)]
CHUNK = 128

_Y_PART = "  if (warp < nw) {"
_CHIN = ("  // y = diag(exp(cum)) C h_in, h_in exact as three bf16 pieces\n"
         "  if (ci > 0) {")
_STEPS = ("  for (int j0 = 0; j0 < i0; j0 += 16)",
          "  causal_step<PT, NK>(acc, cf, Bs, Xs, cum, cum_i, i0, i0, true")
_DECAY = "sc[nt][e] * expf(cum_i[e >> 1] - cum[j])"
_PIECES = "for (int piece = 0; piece < 3; ++piece) {"
_ALLOW = ("cudaError_t allow_smem(K kernel, int smem) {\n"
          "  if (smem <= 48 * 1024) return cudaSuccess;")

# name: ([(old, new), ...], diagnostic)
VARIANTS = {
    "committed": ([], False),
    # the largest shared-memory carveout asked for before the launch
    "max_carveout": ([(_ALLOW, _ALLOW.replace(
        "  if (smem <= 48 * 1024) return cudaSuccess;",
        "  cudaFuncSetAttribute(kernel,\n"
        "                       cudaFuncAttributePreferredSharedMemoryCarveout,\n"
        "                       cudaSharedmemCarveoutMaxShared);\n"
        "  if (smem <= 48 * 1024) return cudaSuccess;"))], False),
    # the decay with the fast exponential (ex2.approx of x log2 e)
    "fast_decay_exp": ([(_DECAY, _DECAY.replace("expf(", "__expf("))],
                       False),
    # diagnostics: the loads, Hc, the hand-over of the state and the split
    # of h_in alone (no y); without C h_in; without the causal steps;
    # without the decay's exponentials; the products with an f32 operand
    # as one piece (hi)
    "no_y": ([(_Y_PART, "  if (false) {")], True),
    "no_c_h_in": ([(_CHIN, _CHIN.replace("if (ci > 0)", "if (false)"))],
                  True),
    "no_causal_steps": ([(old, "  if (false)\n" + old) for old in _STEPS],
                        True),
    "no_decay_exp": ([(_DECAY, "sc[nt][e]")], True),
    "one_piece": ([(_PIECES, _PIECES.replace("piece = 0", "piece = 2"))],
                  True),
}


def build_variants(names):
    src = (build.CSRC / "ssd_scan.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = OUT / f"ssd_{name}.cu"
        cu.write_text(text)
        lib = OUT / f"libssd_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-shared", "-o", str(lib), str(cu)]
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
        regs = [int(ln.split("Used")[1].split()[0])
                for ln in log.splitlines() if "Used" in ln]
        print(json.dumps({"variant": name, "registers": regs,
                          "spills": spills}), flush=True)
        cdll = ctypes.CDLL(str(lib))
        fn = "repro_ssd_scan_bf16"
        getattr(cdll, fn).argtypes = list(build._SIGNATURES[fn])
        getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def run(lib, x, b, c, a):
    bh, length, p = x.shape
    n = b.shape[2]
    nc = -(-length // CHUNK)
    y = torch.empty_like(x)
    state = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    states = torch.empty((bh, nc - 1, n, p), dtype=torch.float32,
                         device=x.device)
    flags = torch.empty(bh * nc + 1, dtype=torch.int32, device=x.device)
    strides = [s for t in (x, b, c, a) for s in t.stride()[:2]]
    err = lib.repro_ssd_scan_bf16(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), y.data_ptr(),
        state.data_ptr(), states.data_ptr(), flags.data_ptr(), bh, length, p,
        n, CHUNK, *strides, build.stream_ptr(x.device))
    build.check(err, "ssd variant")
    return y, state


def time_ms(fn, reps=7, inner=10):
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


def kernel_ms(fn, calls=10):
    """Mean device ms per call of each kernel whose name holds ``ssd_``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0)
        if us and "ssd_" in evt.key:
            out[evt.key.split("(")[0].split("::")[-1]] = us / calls / 1e3
    return out


def main(names) -> int:
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 2
    names = names or list(VARIANTS)
    if "committed" not in names:
        names = ["committed"] + names
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for bh, length, p, n in SHAPES:
        def randn(*shape, scale=1.0):
            return scale * torch.randn(shape, generator=gen, device="cuda")
        x = randn(bh, length, p).to(torch.bfloat16)
        b = randn(bh, length, n, scale=0.5).to(torch.bfloat16)
        c = randn(bh, length, n, scale=0.5).to(torch.bfloat16)
        a = -0.1 * randn(bh, length).abs()
        want = KS.ssd_scan_plain(x, b, c, a, chunk=CHUNK).float()
        # committed first and last, the variants between
        order = ["committed"] + [v for v in names if v != "committed"] \
            + ["committed"]
        for name in order:
            lib = libs[name]
            fn = lambda lib=lib: run(lib, x, b, c, a)
            line = {"variant": name, "shape": [bh, length, p, n],
                    "ms": time_ms(fn), "kernels_ms": kernel_ms(fn)}
            if not VARIANTS[name][1]:
                got = fn()[0].float()
                line["rel_err"] = (torch.linalg.norm(got - want)
                                   / torch.linalg.norm(want)).item()
            print(json.dumps(line), flush=True)
        del x, b, c, a, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
