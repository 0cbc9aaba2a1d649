#!/usr/bin/env python3
"""Two checkouts' main path and ITE times on the card, in turns.

    PYTHONPATH=src python3 tools/parent_turns.py --base DIR [--order ABBA]

``A`` is the checkout this script lies in, ``B`` the one at ``--base`` (for
example an earlier commit unpacked with ``git archive``).  For each letter
of ``--order`` a fresh process in that checkout builds its kernels and runs
its own ``chip_smoke.py`` phases ``main_path`` and ``ite``, with the
script's float settings (no TF32); their checks hold as in a full run.
Each process prints the times those phases' lines carry: per main-path run
(c64 kernel, c64 dense, c128 dense) the gates, norm, energy, amplitudes and
total seconds, and per ITE run the seconds per Trotter step.  One JSON line
per process and run, then per checkout and run the medians, then the
card's ``nvidia-smi`` line.  About three minutes a process.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
import chip_smoke as C
from repro_torch.kernels import build
build.library()
C.phase_main_path(torch, np)
C.phase_ite(torch, np)
"""

MAIN_KEYS = ("gates_s", "norm_s", "energy_s", "amplitudes_s", "total_s")


def run_label(line):
    """The run a phase line reports on, or None for a summary line."""
    if line.get("phase") == "main_path" and "total_s" in line:
        return f"main_path {line['dtype']} {line['mode']}"
    if line.get("phase") == "ite" and "s_per_step" in line:
        return (f"ite {line['run']} {line['dtype']} {line['mode']}"
                f" als_eps={line['update'].get('als_eps')}")
    return None


def times_of(line):
    if line["phase"] == "main_path":
        return {k: line[k] for k in MAIN_KEYS}
    return {"s_per_step": line["s_per_step"], "energy": line["energy"]}


def child(tree: str, timeout: float):
    """Run the phases in ``tree``; returns {run: times} and the exit code."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    runs = {}
    for text in proc.stdout.splitlines():
        try:
            line = json.loads(text)
        except ValueError:
            continue
        label = run_label(line) if isinstance(line, dict) else None
        if label is not None:
            runs[label] = times_of(line)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    return runs, proc.returncode


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--base", required=True,
                        help="the other checkout's root (B)")
    parser.add_argument("--order", default="ABBA")
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args()
    trees = {"A": ROOT, "B": os.path.abspath(args.base)}
    collected = {"A": {}, "B": {}}
    failed = False
    for i, letter in enumerate(args.order):
        runs, rc = child(trees[letter], args.timeout)
        failed |= rc != 0
        for label, times in runs.items():
            collected[letter].setdefault(label, []).append(times)
            print(json.dumps({"turn": i, "tree": letter, "run": label,
                              **times}), flush=True)
        print(json.dumps({"turn": i, "tree": letter, "rc": rc}), flush=True)
    for letter, runs in collected.items():
        for label, reps in runs.items():
            keys = [k for k in reps[0] if k != "energy"]
            print(json.dumps({
                "tree": letter, "path": trees[letter], "run": label,
                "median": {k: statistics.median(r[k] for r in reps)
                           for k in keys},
                "energy": [r["energy"] for r in reps if "energy" in r]}),
                flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
