"""Fault-tolerant LM training loop (launcher).

Counterpart of ``repro.launch.train``:

* auto-resume from the newest valid checkpoint (crash/preemption recovery);
* atomic async checkpoints every ``--checkpoint-every`` steps;
* deterministic data as f(seed, step): restart-safe without data state;
* per-step watchdog timing with straggler logging;
* gradient-accumulation microbatching;
* ``--simulate-failure N`` kills the run at step N (chaos testing: the
  restarted run continues bit for bit);
* elastic restarts: a resume places the checkpoint on whatever mesh this
  run uses.

The step is :meth:`~repro_torch.models.model.ModelBundle.train_step` with
the new parameters and moments written into the old tensors, as the
reference's jitted step donates them.  The model runs on ``--device`` (the
CUDA card by default; ``cpu`` on request).

``--mesh`` (``1x1``, ``2x2``, ``2x4``, ``2x2x2``, named ``(data, model)``
or ``(pod, data, model)`` as the reference names them) runs one process
per cell: rank ``r`` on ``cuda:r`` over NCCL, or on the CPU over gloo with
``--device cpu``.  Started by ``torchrun`` (``RANK`` in the environment)
each process is one rank; otherwise a mesh of more than one cell makes the
launcher start one rank per cell itself.  Each rank takes its shards of
every step's batch, rank 0 alone prints and writes ``--log-file``, and
``--simulate-failure`` ends every rank once the checkpoint is written (the
launcher exits 42).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --steps 16 --checkpoint-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --mesh 2x2 --steps 4
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (init_distributed, make_device_mesh,
                                     spawn_ranks)
from repro_torch.models.model import build
from repro_torch.optim.adamw import OptConfig, adamw_init

#: the launcher's exit code after ``--simulate-failure``
FAILURE_EXIT = 42


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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1x1", help="e.g. 1x1, 2x4, 2x2x2")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="end the run at this step (chaos test)")
    ap.add_argument("--slow-step-factor", type=float, default=3.0,
                    help="watchdog: warn when a step exceeds factor x median")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def _mesh_shape(text: str):
    return tuple(int(x) for x in text.split("x"))


def main(argv=None):
    """Train; returns the final parameters (``None`` where the launcher
    started the ranks itself: they live in those processes)."""
    args = _parser().parse_args(argv)
    cells = math.prod(_mesh_shape(args.mesh))
    if cells > 1 and "RANK" not in os.environ:
        device = resolve_device(args.device)
        if device.type == "cuda" and torch.cuda.device_count() < cells:
            raise RuntimeError(
                f"--mesh {args.mesh} needs {cells} cards, one rank per "
                f"card; {torch.cuda.device_count()} visible")
        import torch.multiprocessing as mp
        argv = list(sys.argv[1:] if argv is None else argv)
        # CPU ranks share the host's cores
        threads = max(1, (os.cpu_count() or 1) // cells) \
            if device.type == "cpu" else 0
        try:
            spawn_ranks(_rank_main, cells, args=(argv,), threads=threads)
        except mp.ProcessExitedException as e:
            if e.exit_code == FAILURE_EXIT:
                sys.exit(FAILURE_EXIT)
            raise
        return None
    return _train(args)


def _rank_main(argv):
    _train(_parser().parse_args(argv))


def _train(args):
    shape = _mesh_shape(args.mesh)
    device = resolve_device(args.device)
    mesh = None
    if math.prod(shape) > 1:
        device = init_distributed(device)
        mesh = make_device_mesh(shape, device_type=device.type)
    lead = mesh is None or dist.get_rank() == 0

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    bundle = build(cfg, OptConfig(lr=args.lr), mesh=mesh)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))

    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    start_step = 0
    params = opt_state = None
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        if lead:
            print(f"[train] resuming from checkpoint step {start_step}")
        shapes = {k: tuple(t.shape) for k, t in _flatten(
            {"params": bundle.abstract_params(),
             "opt": bundle.abstract_opt_state()}).items()}
        shardings = None if mesh is None else {
            "params": bundle.param_shardings(), "opt": bundle.opt_shardings()}
        restored = _unflatten(ckpt.restore(start_step, shapes, device,
                                           shardings=shardings))
        params, opt_state = restored["params"], restored["opt"]
    if params is None:
        params = bundle.init(args.seed, device)
        opt_state = adamw_init(params)

    log_f = open(args.log_file, "a") if args.log_file and lead else None
    durations = []
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = step_batch(cfg, data, step, device)
        if mesh is not None:
            batch = bundle.shard_batch(batch)
        try:
            params, opt_state, metrics = bundle.train_step(
                params, opt_state, batch, microbatches=args.microbatches,
                donate=True)
            loss = float(metrics["loss"])
        except Exception as e:  # noqa: BLE001 — step-level fault tolerance
            print(f"[train] step {step} FAILED ({e}); checkpoint + abort")
            # a sharded save is a collective, which ranks that did not
            # fail would never join
            if ckpt is not None and mesh is None:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          blocking=True)
            raise
        dt = time.time() - t0
        durations.append(dt)
        med = float(np.median(durations[-20:]))
        if lead and len(durations) > 5 and dt > args.slow_step_factor * med:
            print(f"[train] WATCHDOG: step {step} took {dt:.2f}s "
                  f"({dt/med:.1f}x median) — straggler suspected")
        rec = {"step": step, "loss": loss, "sec": round(dt, 4),
               "grad_norm": float(metrics["grad_norm"])}
        if lead:
            print(f"[train] {json.dumps(rec)}")
        if log_f:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
        next_step = step + 1
        if ckpt is not None and next_step % args.checkpoint_every == 0:
            ckpt.save(next_step, {"params": params, "opt": opt_state})
        if args.simulate_failure is not None and next_step == args.simulate_failure:
            if lead:
                print(f"[train] simulating hard failure at step {next_step}")
            if ckpt is not None:
                ckpt.wait()
            if mesh is not None:
                dist.barrier()      # every rank ends once rank 0 has written
            sys.stdout.flush()
            os._exit(FAILURE_EXIT)

    if ckpt is not None:
        ckpt.save(args.steps, {"params": params, "opt": opt_state},
                  blocking=True)
    if log_f:
        log_f.close()
    if lead:
        print("[train] done")
    return params


if __name__ == "__main__":
    main()
