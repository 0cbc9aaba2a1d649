"""Fault-tolerant LM training loop (launcher).

Counterpart of ``repro.launch.train``, on one device:

* auto-resume from the newest valid checkpoint (crash/preemption recovery);
* atomic async checkpoints every ``--checkpoint-every`` steps;
* deterministic data as f(seed, step): restart-safe without data state;
* per-step watchdog timing with straggler logging;
* gradient-accumulation microbatching;
* ``--simulate-failure N`` kills the process at step N (chaos testing: the
  restarted run continues bit for bit).

The step is :meth:`~repro_torch.models.model.ModelBundle.train_step` with
the new parameters and moments written into the old tensors, as the
reference's jitted step donates them.  The model runs on ``--device`` (the
CUDA card by default; ``cpu`` on request).  ``--mesh`` takes only ``1x1``:
multi-device training is PEPS item 9 of ``ROADMAP.md``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --steps 16 --checkpoint-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.model import build
from repro_torch.optim.adamw import OptConfig, adamw_init


def _unflatten(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for key, leaf in flat.items():
        node, parts = out, key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf
    return out


def step_batch(cfg, data: SyntheticLM, step: int, device):
    """The training batch of ``step`` on ``device``: the data's ``tokens``
    and ``labels``, plus the vlm's (3, B, S) positions (0..S-1 on every
    stream) and the encdec's standard-normal f32 frames from
    ``default_rng(step)``, as the reference's launcher makes them."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch_at(step).items()}
    b, s = batch["tokens"].shape
    if cfg.family == "vlm":
        batch["positions"] = torch.arange(
            s, dtype=torch.int32, device=device).expand(3, b, s)
    if cfg.family == "encdec":
        rng = np.random.default_rng(step)
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model), dtype=np.float32)).to(device)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1x1",
                    help="only 1x1: multi-device is PEPS item 9")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="os._exit at this step (chaos test)")
    ap.add_argument("--slow-step-factor", type=float, default=3.0,
                    help="watchdog: warn when a step exceeds factor x median")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if tuple(int(x) for x in args.mesh.split("x")) != (1, 1):
        raise ValueError(f"--mesh {args.mesh}: the port trains on one device "
                         f"(1x1); multi-device training is PEPS item 9 of "
                         f"ROADMAP.md")
    device = resolve_device(args.device)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    bundle = build(cfg, OptConfig(lr=args.lr))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))

    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    start_step = 0
    params = opt_state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        print(f"[train] resuming from checkpoint step {start_step}")
        shapes = {k: tuple(t.shape) for k, t in _flatten(
            {"params": bundle.abstract_params(),
             "opt": bundle.abstract_opt_state()}).items()}
        restored = _unflatten(ckpt.restore(start_step, shapes, device))
        params, opt_state = restored["params"], restored["opt"]
    if params is None:
        params = bundle.init(args.seed, device)
        opt_state = adamw_init(params)

    log_f = open(args.log_file, "a") if args.log_file else None
    durations = []
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = step_batch(cfg, data, step, device)
        try:
            params, opt_state, metrics = bundle.train_step(
                params, opt_state, batch, microbatches=args.microbatches,
                donate=True)
            loss = float(metrics["loss"])
        except Exception as e:  # noqa: BLE001 — step-level fault tolerance
            print(f"[train] step {step} FAILED ({e}); checkpoint + abort")
            if ckpt is not None:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          blocking=True)
            raise
        dt = time.time() - t0
        durations.append(dt)
        med = float(np.median(durations[-20:]))
        if len(durations) > 5 and dt > args.slow_step_factor * med:
            print(f"[train] WATCHDOG: step {step} took {dt:.2f}s "
                  f"({dt/med:.1f}x median) — straggler suspected")
        rec = {"step": step, "loss": loss, "sec": round(dt, 4),
               "grad_norm": float(metrics["grad_norm"])}
        print(f"[train] {json.dumps(rec)}")
        if log_f:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
        next_step = step + 1
        if ckpt is not None and next_step % args.checkpoint_every == 0:
            ckpt.save(next_step, {"params": params, "opt": opt_state})
        if args.simulate_failure is not None and next_step == args.simulate_failure:
            print(f"[train] simulating hard failure at step {next_step}")
            if ckpt is not None:
                ckpt.wait()
            os._exit(42)

    if ckpt is not None:
        ckpt.save(args.steps, {"params": params, "opt": opt_state},
                  blocking=True)
    if log_f:
        log_f.close()
    print("[train] done")
    return params


if __name__ == "__main__":
    main()
