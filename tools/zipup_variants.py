#!/usr/bin/env python3
"""Time variants of the zip-up site kernels on the card, and the host's
share of a site call.

    PYTHONPATH=src python3 tools/zipup_variants.py [name ...]

Each variant is ``src/repro_torch/kernels/csrc/zipup_block.cu`` with a few
text substitutions (``VARIANTS``), built by its own ``nvcc`` (all started
together) into the git-ignored ``src/repro_torch/kernels/_build/variants/``
and loaded in place of the port's library, so the site's own wrapper calls
it.  ``recompute_t1`` is the other design of the two-layer chain: every
thread recomputes each entry of t1 it needs, where the committed kernel
has each run of threads that differ only in the ket's trailing output
axis (K) compute the entries once, into shared memory, and share them.  At each site's
main shape (complex64, D = 6) every variant is held against the plain
version and timed in turns (committed, variants, committed): the call's
time from CUDA events (median of 7 x 20 calls), then the kernel's device
time from torch.profiler (mean of 200 calls).  Then the committed wrapper's
host time is taken apart with the host clock (mean of 2,000 calls, no
synchronisation inside): the whole call through dispatch, the kernel form,
its operand checks, the output allocation, the bare ctypes launch, the
launch with its stream looked up (as before the device guard) and the
same launch through ``build.launch`` (the stream and the guard).
Prints one JSON line per measurement, and the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from array import array

import torch

from repro_torch.kernels import build, dispatch
from repro_torch.kernels import zipup_block as Z

OUT = build.BUILD_ROOT / "variants"

_CHAIN_KERNEL = "// Threads [g run, (g + 1) run) of a block differ only"
_CHAIN_END = "int grid_of(long long n_out) {"
_LAUNCH = "  // the run of trailing output axes x and y lack, within one block"
_LAUNCH_END = "  return static_cast<int>(cudaGetLastError());"
# the chain's other design: every thread recomputes each t1 entry it needs
_RECOMPUTE_KERNEL = r'''template <bool CPLX, bool BF16>
__global__ void __launch_bounds__(THREADS)
zipup_chain_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ z, float* __restrict__ out,
                   const ChainArgs p, int flags) {
  const bool conj_x = flags & F_CONJ0, conj_y = flags & (F_CONJ0 << 1),
             conj_z = flags & (F_CONJ0 << 2);
  const bool round_t1 = BF16 || (flags & F_ROUND_T1);
  for (long long o = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       o < p.n_out; o += static_cast<long long>(gridDim.x) * THREADS) {
    long long off[3];
    offsets<3>(p.out, o, p.n_out, off);
    float2 acc = make_float2(0.f, 0.f);
    for (long long i0 = 0; i0 < p.osize[0]; ++i0) {
      for (long long i1 = 0; i1 < p.osize[1]; ++i1) {
        long long offx = off[0] + i0 * p.ostride[0][0] + i1 * p.ostride[0][1];
        long long offy = off[1] + i0 * p.ostride[1][0] + i1 * p.ostride[1][1];
        // stage 1: this (i0, i1)'s entry of t1, summed in f32 ...
        float2 t1 = make_float2(0.f, 0.f);
        for (long long j = 0; j < p.isize; ++j) {
          mac<CPLX>(t1, load<CPLX, BF16>(x, offx, conj_x),
                    load<CPLX, BF16>(y, offy, conj_y));
          offx += p.istride[0];
          offy += p.istride[1];
        }
        // ... rounded where the reference's second GEMM rounds it
        if (round_t1) t1 = make_float2(bf16_round(t1.x), bf16_round(t1.y));
        // stage 2
        mac<CPLX>(acc, t1,
                  load<CPLX, BF16>(
                      z, off[2] + i0 * p.ostride[2][0] + i1 * p.ostride[2][1],
                      conj_z));
      }
    }
    store<CPLX>(out, o, acc);
  }
}

'''
_RECOMPUTE_LAUNCH = r'''  const dim3 grid(grid_of(p.n_out));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & F_COMPLEX) {
    if (flags & F_BF16)
      zipup_chain_kernel<true, true><<<grid, THREADS, 0, st>>>(fx, fy, fz, fo,
                                                              p, flags);
    else
      zipup_chain_kernel<true, false><<<grid, THREADS, 0, st>>>(fx, fy, fz,
                                                               fo, p, flags);
  } else {
    if (flags & F_BF16)
      zipup_chain_kernel<false, true><<<grid, THREADS, 0, st>>>(fx, fy, fz,
                                                               fo, p, flags);
    else
      zipup_chain_kernel<false, false><<<grid, THREADS, 0, st>>>(fx, fy, fz,
                                                                fo, p, flags);
  }
'''

# name: [(old, new), ...]; "@CHAIN" replaces the chain kernel's template,
# "@CHAIN_LAUNCH" the chain entry point's launch
VARIANTS = {
    "committed": [],
    "recompute_t1": [("@CHAIN", _RECOMPUTE_KERNEL),
                     ("@CHAIN_LAUNCH", _RECOMPUTE_LAUNCH)],
}


def variant_source(name, src):
    text = src
    for old, new in VARIANTS[name]:
        if old == "@CHAIN":
            a, b = text.index(_CHAIN_KERNEL), text.index(_CHAIN_END)
            text = text[:a] + new + text[b:]
            continue
        if old == "@CHAIN_LAUNCH":
            a = text.index(_LAUNCH)
            b = text.index(_LAUNCH_END, a)
            text = text[:a] + new + text[b:]
            continue
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def build_variants(names):
    src = (build.CSRC / "zipup_block.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"zipup_{name}.cu"
        cu.write_text(variant_source(name, src))
        lib = OUT / f"libzipup_{name}.so"
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
        regs = sorted(set(int(ln.split("Used")[1].split()[0])
                          for ln in log.splitlines() if "Used" in ln))
        print(json.dumps({"variant": name, "registers": regs,
                          "spills": spills}), flush=True)
        cdll = ctypes.CDLL(str(lib))
        for fn in ("repro_zipup_pair", "repro_zipup_chain"):
            getattr(cdll, fn).argtypes = list(build._SIGNATURES[fn])
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


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


def device_ms(fn, calls=200):
    """Mean device time of the kernels ``fn`` launches, per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if us is None else us
    return total / 1e3 / calls


def host_us(fn, calls=2000):
    """Mean host time of ``fn`` (no synchronisation inside), in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def operands(site, gen, layout):
    def c(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device="cuda"),
                             torch.randn(shape, generator=gen, device="cuda"))
    if site == "zipup_first_onelayer":
        xs = [c(1, 6, 6), c(6, 1, 6, 6)]
    elif site == "zipup_first_twolayer":
        xs = [c(1, 6, 6, 36), c(2, 6, 1, 6, 6), c(2, 6, 1, 6, 6)]
    else:
        xs = [c(2, 1, 6, 6, 6), c(2, 1, 6, 6, 6)]
    if layout == "bra_conj" and site != "zipup_first_onelayer":
        bra = 0 if site == "pair_merge" else 1
        xs[bra] = xs[bra].conj()
    return xs


SITES = {"zipup_first_onelayer": (Z.first_column_onelayer,
                                  Z.first_onelayer_plain, "repro_zipup_pair"),
         "zipup_first_twolayer": (Z.first_column_twolayer,
                                  Z.first_twolayer_plain, "repro_zipup_chain"),
         "pair_merge": (Z.pair_merge, Z.pair_merge_plain, "repro_zipup_pair")}


def host_breakdown(site, xs):
    """The committed wrapper's host time, taken apart."""
    entry, _, lib_fn = SITES[site]
    kernel = dispatch.site(site).kernel_fn
    fn = "breakdown"
    _, work, _ = Z._cuda_operands(fn, xs)
    out = kernel(*xs)
    # the arguments of this call, as the wrapper builds them, the int64
    # array copied while the wrapper holds it
    captured = {}
    real = build.library()

    class Spy:
        def __getattr__(self, name):
            def call(*args):
                p = ctypes.cast(args[-3], ctypes.POINTER(ctypes.c_longlong))
                nd = p[0]
                n = 1 + 3 * nd + 9 if len(xs) == 2 else 1 + 4 * nd + 11
                captured["argv"] = array("q", (p[i] for i in range(n)))
                captured["args"] = list(args)
                return getattr(real, name)(*args)
            return call
    build._lib = Spy()
    try:
        kernel(*xs)
    finally:
        build._lib = real
    argv, args = captured["argv"], captured["args"]
    args[-3] = argv.buffer_info()[0]
    args[len(xs)] = out.data_ptr()
    bare = getattr(real, lib_fn)
    return {
        "dispatch_call_us": host_us(lambda: entry(*xs)),
        "kernel_form_us": host_us(lambda: kernel(*xs)),
        "operand_checks_us": host_us(lambda: Z._cuda_operands(fn, xs)),
        "torch_empty_us": host_us(lambda: torch.empty(
            out.shape, dtype=work, device=out.device)),
        "bare_ctypes_launch_us": host_us(lambda: bare(*args)),
        # the launch as it was before the device guard: the stream looked
        # up for the call, no guard
        "stream_ptr_launch_us": host_us(lambda: bare(
            *args[:-1], build.stream_ptr(out.device))),
        # the same launch through build.launch: the current stream's
        # lookup and the device guard (a cached card count on one card)
        # on top of the bare call
        "guarded_launch_us": host_us(lambda: build.launch(
            bare, out.device, *args[:-1])),
    }


def main(names):
    if not torch.cuda.is_available():
        print("zipup_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = ["committed"] + [n for n in (names or VARIANTS)
                             if n != "committed"]
    libs = build_variants(names)
    own = build.library()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    prev = dispatch.set_kernel_backend("kernel")
    try:
        for site, (entry, plain, _) in SITES.items():
            for layout in ("contiguous", "bra_conj"):
                xs = operands(site, gen, layout)
                want = plain(*xs)
                order = ["committed"] + names[1:] + ["committed"]
                res = {}
                # the call times first: profiling can slow the launches
                # after it
                for key, timer in (("ms", time_ms), ("device_ms", device_ms)):
                    for name in order:
                        build._lib = libs[name]
                        got = entry(*xs)
                        err = (torch.linalg.norm(got - want)
                               / torch.linalg.norm(want)).item()
                        if not err <= 1e-5:
                            raise SystemExit(f"variant {name} {site}: rel "
                                             f"err {err}")
                        r = res.setdefault(name, {"ms": [], "device_ms": [],
                                                  "rel_err": err})
                        r[key].append(timer(lambda: entry(*xs)))
                build._lib = own
                for name, r in res.items():
                    print(json.dumps({"variant": name, "site": site,
                                      "layout": layout,
                                      "shapes": [list(x.shape) for x in xs],
                                      **r}), flush=True)
                exprs = {"zipup_first_onelayer": "bfg,fchk->bchgk",
                         "zipup_first_twolayer": "bfFg,pfchk,pFCHK->bcChHgkK",
                         "pair_merge": "puldr,pULDR->lLdDrR"}
                print(json.dumps({
                    "site": site, "layout": layout,
                    "einsum_ms": time_ms(lambda: torch.einsum(exprs[site],
                                                              *xs)),
                    "plain_ms": time_ms(lambda: plain(*xs)),
                    "host": host_breakdown(site, xs)}), flush=True)
    finally:
        build._lib = own
        dispatch.set_kernel_backend(prev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
