"""Multi-pod dry-run of the port — counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape) cell it runs one rank's step on
the reference's production meshes, (data 16, model 16) = 256 ranks and
(pod 2, data 16, model 16) = 512 ranks, and records the per-device
flops, bytes accessed, collective bytes and op counts per kind, argument
and temporary memory, and the roofline's three terms
(:mod:`repro_torch.launch.roofline`).

The reference lowers and compiles each cell for fake XLA host devices and
reads ``cost_analysis()``, ``memory_analysis()`` and the HLO's
collectives.  PyTorch has no ahead-of-time lowering of an eager program,
so here the world is faked instead: a fake process group of 256 or 512
ranks with this process as rank 0
(:func:`repro_torch.launch.mesh.make_production_mesh`), the parameters,
optimizer state, batch and cache as ``DTensor``s over ``FakeTensorMode``
tensors (shapes, dtypes and placements; nothing allocated), and the step
run once under :mod:`repro_torch.launch.cost_analysis`'s counters.  What
is counted is what rank 0 of the real world would run.

Differences from the reference, by design:

* The unroll probes (``_scan_trips``, ``_unroll_factor`` and the probe
  compiles) are not ported: they correct for XLA's ``cost_analysis``
  counting a scan body once, and the port's eager step runs every layer.
* Kernel sites run dense (``dispatch.forced_dense()``): the reference's
  dry-run on host devices takes its ``jnp`` path too, and a fake tensor
  cannot go through a kernel launch.  Nothing is launched on any device.
* The PEPS cells (the cyclops bond sharding) are not ported
  (ROADMAP PEPS item 9): :func:`run_peps_cell` raises
  ``NotImplementedError`` and ``--all`` records them as ``not_ported``.

Usage (``PYTHONPATH=src``; a CPU host will do):
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
    python -m repro_torch.launch.dryrun --all --jobs 6      # cells at once
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
        --mesh 2x2 --seq 2048 --batch 4      # a cell cut to a small world
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch

LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
PEPS_SHAPES = ["evolve", "contract"]
PEPS_NOT_PORTED = ("the dry-run's PEPS cells need the cyclops bond "
                   "sharding (site_sharding, peps_shardings, "
                   "carry_model_constraint), which is not ported "
                   "(ROADMAP PEPS item 9)")
MICROBATCHES = 8


def _mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "x".join(str(int(s)) for s in mesh_shape)
    return "2x16x16" if multi_pod else "16x16"


def _skip_record(arch, shape, mesh_name, reason):
    return {"arch": arch, "shape": shape, "mesh": mesh_name,
            "status": "skipped", "reason": reason}


def _placed(stand_in, sharding, device):
    """A ``DTensor`` of ``stand_in``'s shape and dtype placed by
    ``sharding``, its local shard an empty tensor on ``device`` (a fake
    one under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import _contiguous, local_slices
    shape = tuple(stand_in.shape)
    local = tuple(s.stop - s.start for s in local_slices(
        shape, sharding.placements, sharding.mesh))
    return DTensor.from_local(
        torch.empty(local, dtype=stand_in.dtype, device=device),
        sharding.mesh, sharding.placements, shape=torch.Size(shape),
        stride=_contiguous(shape), run_check=False)


def _placed_tree(stand_ins, shardings, device):
    if isinstance(stand_ins, dict):
        return {k: _placed_tree(v, shardings[k], device)
                for k, v in stand_ins.items()}
    return _placed(stand_ins, shardings, device)


_TRACING_MODULES = (
    "torch.distributed._functional_collectives",
    "torch.distributed.tensor._collective_utils",
    "torch.distributed.tensor._decompositions",
    "torch.distributed.tensor._dispatch",
    "torch.distributed.tensor._redistribute",
    "torch.distributed.tensor._sharding_prop",
)


@contextlib.contextmanager
def eager_dtensor():
    """``DTensor`` run as it runs eagerly, under ``FakeTensorMode`` too.

    ``DTensor`` takes ``FakeTensorMode`` for a compiler's trace
    (``_functional_collectives._are_we_tracing``) and then skips its
    sharding and redistribute-plan caches and pads shards it would not
    pad eagerly.  The dry-run's step is an eager step on fake data, so
    here only a compiler or a proxy trace counts as tracing: the step
    runs the ops, collectives and caches of the real one (its counts equal
    a real world's, ``tests/test_torch_lm_sharded.py``)."""
    import importlib
    from torch._dynamo.external_utils import is_compiling
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    def tracing() -> bool:
        return bool(is_compiling()) or get_proxy_mode() is not None

    saved = []
    for name in _TRACING_MODULES:
        module = importlib.import_module(name)
        if hasattr(module, "_are_we_tracing"):
            saved.append((module, module._are_we_tracing))
            module._are_we_tracing = tracing
    try:
        yield
    finally:
        for module, original in saved:
            module._are_we_tracing = original


def _lower_cell(bundle, cfg, io, kind, seq: int, microbatches: int = 1):
    """One step of the cell on ``bundle``'s mesh, on placed fake tensors,
    under the counters: its :class:`~repro_torch.launch.cost_analysis.Cost`
    (the reference's lowering and compile of the cell).  A decode step
    writes the cache's last position (``seq - 1``), so its attention
    reads the whole cache, as the reference's over its full-length cache
    does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import dispatch
    from repro_torch.launch import cost_analysis
    from repro_torch.models.common import mesh_device
    device = mesh_device(bundle.mesh)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            dispatch.forced_dense(), eager_dtensor():
        params = _placed_tree(bundle.abstract_params(),
                              bundle.param_shardings(), device)
        if kind == "train":
            opt = _placed_tree(bundle.abstract_opt_state(),
                               bundle.opt_shardings(), device)
            batch = _placed_tree(io["batch"], io["batch_shardings"], device)
            return cost_analysis.run(bundle.train_step, params, opt, batch,
                                     microbatches=microbatches)[1]
        with torch.no_grad():
            if kind == "prefill":
                if cfg.family == "encdec":
                    frames = _placed(io["frames"], io["frames_sharding"],
                                     device)
                    return cost_analysis.run(bundle.encode_step, params,
                                             frames)[1]
                tokens = _placed(io["tokens"], io["tokens_sharding"], device)
                return cost_analysis.run(bundle.prefill_step, params,
                                         tokens)[1]
            cache = {k: _placed(v, io["cache_shardings"][k], device)
                     for k, v in io["cache"].items() if k != "index"}
            cache["index"] = seq - 1
            token = _placed(io["token"], io["token_sharding"], device)
            positions = None
            if "positions" in io:
                positions = torch.zeros(io["positions"].shape,
                                        dtype=io["positions"].dtype,
                                        device=device)
            return cost_analysis.run(bundle.serve_step, params, cache, token,
                                     positions)[1]


def run_lm_cell(arch: str, shape: str, multi_pod: bool,
                verbose: bool = True, cfg_overrides=None, mesh_shape=None,
                seq=None, batch=None, config=None) -> dict:
    """One LM cell on the production mesh (or a fake mesh of
    ``mesh_shape``; ``seq`` and ``batch`` cut the shape, ``config``
    replaces the published one): its roofline row with ``status: "ok"``,
    or a skip record by the reference's rules."""
    import dataclasses as _dc
    from repro_torch import configs
    from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
    from repro_torch.launch.roofline import build_roofline
    from repro_torch.models.model import SHAPES, build
    from repro_torch.optim.adamw import OptConfig
    cfg = _dc.replace(config or configs.get(arch), **(cfg_overrides or {}))
    mesh_name = _mesh_name(multi_pod, mesh_shape)
    s0, b0, kind = SHAPES[shape]
    seq, gbatch = seq or s0, batch or b0
    if shape == "long_500k" and not cfg.sub_quadratic:
        return _skip_record(arch, shape, mesh_name,
                            "full attention: O(L) KV at 500k infeasible "
                            "(DESIGN.md SS4)")
    if kind == "decode" and cfg.family == "encdec" and shape == "long_500k":
        return _skip_record(arch, shape, mesh_name, "whisper 448-token decoder")

    mesh = (make_production_mesh(multi_pod) if mesh_shape is None
            else make_fake_mesh(mesh_shape))
    chips = mesh.size()
    t0 = time.time()
    bundle = build(cfg, OptConfig(), mesh=mesh)
    io = bundle.input_specs(shape, seq, gbatch)
    cost = _lower_cell(bundle, cfg, io, kind, seq)
    t_step = time.time() - t0
    roof = build_roofline(arch, shape, mesh_name, chips, cost, cfg, kind,
                          seq, gbatch)

    # train: the deployable microbatched step, whose temporaries must fit
    # the card (live activations / m)
    deploy_temp = None
    if kind == "train" and gbatch % MICROBATCHES == 0:
        deploy_temp = _lower_cell(bundle, cfg, io, kind, seq,
                                  MICROBATCHES).temp_bytes
    rec = roof.row()
    rec.update({
        "status": "ok", "seq": seq, "global_batch": gbatch,
        "step_wall_s": round(t_step, 1),
        "wall_s": round(time.time() - t0, 1),
        "deploy_temp_bytes_per_device": deploy_temp,
        "microbatches": MICROBATCHES if deploy_temp is not None else None,
    })
    if verbose:
        print(f"[{arch} x {shape} @ {mesh_name}] OK ({rec['wall_s']:.0f}s)")
        print(f"  memory: args={rec['arg_bytes_per_device'] / 2**30:.2f}GiB "
              f"temp={rec['temp_bytes_per_device'] / 2**30:.2f}GiB per "
              f"device" + (f" | deploy(mb={MICROBATCHES}): "
                           f"temp={deploy_temp / 2**30:.2f}GiB"
                           if deploy_temp else ""))
        print(f"  cost: flops/dev={rec['per_device_flops']:.3e} "
              f"bytes/dev={rec['per_device_bytes']:.3e}")
        print(f"  collectives/dev: {rec['collective_bytes']:.3e} B "
              f"{rec['collective_counts']}")
        print(f"  roofline: compute={rec['compute_s'] * 1e3:.2f}ms "
              f"memory={rec['memory_s'] * 1e3:.2f}ms "
              f"collective={rec['collective_s'] * 1e3:.2f}ms "
              f"-> bottleneck={rec['bottleneck']} "
              f"frac={rec['roofline_frac']:.3f}")
    return rec


def run_peps_cell(shape: str, multi_pod: bool, verbose: bool = True):
    """The reference's PEPS cells (a batched evolve and contract of
    cyclops-sharded states): not ported."""
    raise NotImplementedError(PEPS_NOT_PORTED)


def run_cell(arch: str, shape: str, multi_pod: bool, verbose=True,
             **kw) -> dict:
    """:func:`run_lm_cell` or :func:`run_peps_cell`; a cell that raises is
    recorded as ``error`` (``not_ported`` for ``NotImplementedError``)."""
    mesh_name = _mesh_name(multi_pod, kw.get("mesh_shape"))
    try:
        if arch == "peps-rqc":
            return run_peps_cell(shape, multi_pod, verbose)
        return run_lm_cell(arch, shape, multi_pod, verbose=verbose, **kw)
    except NotImplementedError as e:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "not_ported", "reason": str(e)}
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def _quiet_dtensor_warnings():
    """DTensor warns once per redistribute pattern that a multi-axis
    redistribute takes several collectives; the counts already say so."""
    import logging
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed.tensor._collective_utils"):
        logging.getLogger(name).setLevel(logging.ERROR)


def _run_cell_quietly(cell) -> dict:
    """:func:`run_cell` in a pool worker."""
    _quiet_dtensor_warnings()
    return run_cell(*cell)


def summary(results) -> dict:
    """Counts of the records by status."""
    out = {s: 0 for s in ("ok", "skipped", "not_ported", "error")}
    for r in results:
        out[r.get("status", "error")] = out.get(r.get("status", "error"),
                                                0) + 1
    return out


def main(argv=None):
    from repro_torch import configs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (or peps-rqc)")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--mesh", default=None,
                    help="a fake mesh such as 2x2 or 2x1x2 instead of the "
                         "production one")
    ap.add_argument("--seq", type=int, default=None,
                    help="cut the shape's sequence length")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at once, each worker a process "
                         "with a fake world of its own")
    args = ap.parse_args(argv)
    _quiet_dtensor_warnings()

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())

    def done(a, s, m):
        return any(r["arch"] == a and r["shape"] == s and r["mesh"] == m
                   and r.get("status") in ("ok", "skipped")
                   for r in results)

    def record(rec):
        nonlocal results
        results = [r for r in results if not (
            r["arch"] == rec["arch"] and r["shape"] == rec["shape"] and
            r["mesh"] == rec["mesh"])]
        results.append(rec)
        out_path.write_text(json.dumps(results, indent=1, default=str))

    if args.all:
        cells = [(a, s) for a in configs.ARCHS for s in LM_SHAPES]
        cells += [("peps-rqc", s) for s in PEPS_SHAPES]
        meshes = [False] if args.single_pod_only else [False, True]
        todo = [(arch, shape, multi_pod) for multi_pod in meshes
                for arch, shape in cells
                if not done(arch, shape, _mesh_name(multi_pod))]
        if args.jobs <= 1:
            for cell in todo:
                record(run_cell(*cell))
        else:
            import concurrent.futures
            import multiprocessing
            with concurrent.futures.ProcessPoolExecutor(
                    args.jobs, mp_context=multiprocessing.get_context(
                        "spawn")) as pool:
                futures = [pool.submit(_run_cell_quietly, cell)
                           for cell in todo]
                for future in concurrent.futures.as_completed(futures):
                    record(future.result())
        n = summary(results)
        print(f"\nDRY-RUN SUMMARY: {n['ok']} ok, {n['skipped']} skipped, "
              f"{n['not_ported']} not_ported, {n['error']} errors "
              f"(of {len(results)} cells)")
        raise SystemExit(1 if n["error"] else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    mesh_shape = (tuple(int(s) for s in args.mesh.split("x"))
                  if args.mesh else None)
    rec = run_cell(args.arch, args.shape, args.multi_pod,
                   **({} if args.arch == "peps-rqc" else
                      {"mesh_shape": mesh_shape, "seq": args.seq,
                       "batch": args.batch}))
    record(rec)
    print(json.dumps(rec, default=str))
    raise SystemExit(0 if rec.get("status") in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
