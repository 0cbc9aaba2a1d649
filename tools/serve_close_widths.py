#!/usr/bin/env python3
"""Batch-size dependence of the served final-row close on the card.

    PYTHONPATH=src python3 tools/serve_close_widths.py [--reps 7]

``bmps.final_row_amplitudes`` closes a batch of queries against one prefix
environment with batched einsums, in tiles of ``bmps.CLOSE_WIDTH`` (64).
A GEMM's rounding of one row can depend on the GEMM's shape, so without
the fixed width a query's value could depend on the queries it was
batched with.  At the 8x8 main path's shapes (``chip_smoke.py``: prefix
environment of bond 64 and dangling bond 6, final-row sites of bond 6,
complex64, random entries) this script prints, as JSON lines:

* ``width``: for every bucket size B of the serving engine's default
  ladder, whether query 0 closed in a batch of B equals (bit for bit)
  query 0 closed alone, and its relative gap: unpadded (the close's width
  set to B) and at the committed width;
* ``position``: at the committed width, for how many of the 64 positions
  query 0 keeps the bits it has at position 0;
* ``time``: the median time of one close of B queries, unpadded and at
  the committed width (CUDA events, 10 calls a rep);

and the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402
from repro_torch.core import bmps  # noqa: E402
from repro_torch.core.serving import DEFAULT_BUCKETS  # noqa: E402

NCOL, CHI, D = C.GRID, C.CHI, C.RANK
WIDTH = bmps.CLOSE_WIDTH


def close(env, sites, bits, unpadded: bool):
    """``final_row_amplitudes``; ``unpadded`` sets the width to the batch."""
    try:
        if unpadded:
            bmps.CLOSE_WIDTH = len(bits)
        return bmps.final_row_amplitudes(env, sites, bits)
    finally:
        bmps.CLOSE_WIDTH = WIDTH


def operands(seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device="cuda"),
            torch.randn(shape, generator=gen, device="cuda"))

    bonds = [1] + [CHI] * (NCOL - 1) + [1]
    env = [rnd(bonds[j], D, bonds[j + 1]) for j in range(NCOL)]
    sites = [rnd(2, D, 1 if j == 0 else D, 1, 1 if j == NCOL - 1 else D)
             for j in range(NCOL)]
    bits = np.random.default_rng(seed + 1).integers(0, 2, (WIDTH, NCOL))
    return env, sites, bits


def time_ms(fn, reps: int, inner: int = 10) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_close_widths: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    env, sites, bits = operands()
    for unpadded in (True, False):
        alone = close(env, sites, bits[:1], unpadded)[0]
        rows = {}
        for b in DEFAULT_BUCKETS:
            v = close(env, sites, bits[:b], unpadded)[0]
            rows[b] = {"equal": bool(v == alone),
                       "rel_gap": abs(complex(v - alone)) / abs(complex(alone))}
        C.emit({"what": "width", "width": "B" if unpadded else WIDTH,
                "by_batch": rows})
    full = close(env, sites, bits, False)[0]
    same = 0
    for pos in range(WIDTH):
        perm = bits.copy()
        perm[[0, pos]] = perm[[pos, 0]]
        same += bool(close(env, sites, perm, False)[pos] == full)
    C.emit({"what": "position", "width": WIDTH, "positions": WIDTH,
            "equal": same})
    times = {b: {"unpadded_ms": time_ms(
                     lambda b=b: close(env, sites, bits[:b], True), args.reps),
                 "width_64_ms": time_ms(
                     lambda b=b: close(env, sites, bits[:b], False),
                     args.reps)}
             for b in DEFAULT_BUCKETS}
    C.emit({"what": "time", "shapes": {"ncol": NCOL, "chi": CHI, "d": D,
                                       "dtype": "complex64"},
            "by_batch": times})
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
