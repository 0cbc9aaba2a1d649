#!/usr/bin/env python3
"""Does ``torch.profiler`` lose device events on the card, and where?

    KINETO_LOG_LEVEL=1 PYTHONPATH=src python3 tools/trace_probe.py \\
        [--launches 2000 20000 100000] [--reps 3] 2> kineto.log

For each target count of kernel launches, and each way of taking the
trace, it runs a workload of about that many launches under
``torch.profiler`` ``--reps`` times and holds every trace to
``chip_smoke.trace_complete``: each ``cudaLaunchKernel``/``cuLaunchKernel``
runtime record must have a device kernel with its correlation id.  Two
workloads: ``layers`` (a bf16 GEMM of 4096 x 2560 by 2560 x 2560 and six
elementwise kernels, repeated) and ``storm`` (one elementwise kernel on
1,024 floats, repeated: the host launches as fast as it can).  The ways
(``--ways``): ``default`` (CPU and CUDA activities), ``cuda_only`` (CUDA
activity alone: are the runtime records still there?), ``chrome`` (the
default trace exported as a Chrome trace, its ``args.correlation`` counted
independently of the Kineto events, to check ``trace_complete``'s
reading), ``margin`` (the default trace with the card idle for
``--margin`` seconds at both ends) and ``padded`` (the default trace
between two runs of ``chip_smoke.TRACE_PAD_KERNELS`` one-kernel launches,
as ``chip_smoke.traced`` takes its traces; the record counts the work's
launches, and the pads' losses apart).  Prints one JSON line per trace:
``chip_smoke.trace_record`` (the work's launches, those without a kernel
and where they fall in launch order, the pads' losses, the clock skew),
all launches without a kernel and their runs, the device kernels, wall
seconds; then the card's ``nvidia-smi`` line.
Kineto writes its own messages (buffer requests, dropped records) to
standard error at the level of ``KINETO_LOG_LEVEL`` (0 verbose, 1 info,
2 warning).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as CS  # noqa: E402

WAYS = ("default", "cuda_only", "chrome", "margin", "padded")


def workload(kind: str, launches: int):
    """A callable that launches about ``launches`` kernels."""
    if kind == "storm":
        x = torch.ones(1024, device="cuda")

        def run():
            for _ in range(launches):
                x.mul_(1.0)
        return run
    x = torch.randn(4096, 2560, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2560, 2560, device="cuda", dtype=torch.bfloat16) * 0.02

    def run():
        h = x
        for _ in range(max(1, launches // 7)):
            y = F.silu(h @ w)
            y = (y * 1.0001 + h).float()
            h = (y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-6)
                 ).to(torch.bfloat16)
        return h
    return run


def chrome_missing(prof):
    """(launches, launches without a kernel) read from the exported Chrome
    trace's ``args.correlation``."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launches, kernels = [], set()
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                CS.LAUNCH_CALL.match(e.get("name", "")):
            launches.append(corr)
        elif e.get("cat") == "kernel":
            kernels.add(corr)
    return len(launches), sum(c not in kernels for c in launches)


def trace_launches(prof) -> list:
    """The correlation ids of a trace's kernel launches, in launch order."""
    return [c for _, c in CS._launches_and_kernels(prof)[0]]


def trace_kernel_count(prof) -> int:
    """Device kernels in a trace (memory copies and sets not counted)."""
    return sum(1 for evt in CS._trace_events(prof) if CS._is_device(evt)
               and not evt.name().startswith(("Memcpy", "Memset")))


def runs_of(indices):
    return sum(1 for i, x in enumerate(indices)
               if i == 0 or x != indices[i - 1] + 1)


def one_trace(run, way, margin):
    activities = ([ProfilerActivity.CUDA] if way == "cuda_only" else
                  [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    idle = margin if way == "margin" else 0.0
    pads = CS.TRACE_PAD_KERNELS if way == "padded" else 0
    pad = torch.zeros(1024, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(pads):
            pad.add_(1)
        time.sleep(idle)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(idle)
        for _ in range(pads):
            pad.add_(1)
        torch.cuda.synchronize()
    order = trace_launches(prof)
    missing = set(CS.trace_complete(prof))
    idx = [i for i, corr in enumerate(order) if corr in missing]
    line = {**CS.trace_record(prof, pads), "missing_all": len(idx),
            "device_kernels": trace_kernel_count(prof), "wall_s": wall}
    if idx:
        line["missing_runs"] = runs_of(idx)
    if way == "chrome":
        line["chrome_launches"], line["chrome_missing"] = chrome_missing(prof)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launches", type=int, nargs="+",
                    default=[2000, 20000, 100000])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ways", nargs="+", default=list(WAYS), choices=WAYS)
    ap.add_argument("--workloads", nargs="+", default=["layers", "storm"])
    ap.add_argument("--margin", type=float, default=0.25,
                    help="idle seconds at both ends of a 'margin' trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"warm": CS.warm_profiler(torch)}), flush=True)
    for kind in args.workloads:
        for n in args.launches:
            run = workload(kind, n)
            run()
            for way in args.ways:
                for rep in range(args.reps):
                    try:
                        line = one_trace(run, way, args.margin)
                    except Exception as e:  # noqa: BLE001 — report and go on
                        line = {"error": f"{type(e).__name__}: {e}"[:300]}
                    print(json.dumps({"workload": kind, "target": n,
                                      "way": way, "rep": rep, **line}),
                          flush=True)
    print(CS.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
