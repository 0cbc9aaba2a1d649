"""Rank-side bodies of the sharded-training and sharded-serving tests
(imports torch and the port only, never JAX): each runs in one of the
processes that ``repro_torch.launch.mesh.spawn_ranks`` starts, joins the
gloo group, builds its ``DeviceMesh`` and writes what rank 0 holds to
files that the test reads."""
import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 opt_state_from_numpy)
from repro_torch.launch.mesh import (init_distributed, make_device_mesh,
                                     spawn_ranks)
from repro_torch.models.common import distribute, tree_leaves
from repro_torch.models.model import build
from repro_torch.optim.adamw import OptConfig
from repro_torch.optim.compression import init_error_state


def spawn_in_background(fn, world, args):
    """``spawn_ranks(fn, world, args, threads=1)`` on a thread, so that the
    caller computes its references meanwhile; returns a ``join`` that
    waits for the ranks and re-raises what they raised."""
    failure = []

    def run():
        try:
            spawn_ranks(fn, world, args=args, threads=1)
        except BaseException as e:  # noqa: BLE001 — re-raised by join
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if failure:
            raise failure[0]
    return join


def write_case(path, params, opt, batch):
    """A case file: numpy parameters, AdamW state and batch, flattened."""
    flat = {}
    for prefix, tree in (("params", params), ("opt", opt), ("batch", batch)):
        for keys, leaf in tree_leaves(tree):
            flat["/".join((prefix,) + keys)] = np.asarray(leaf)
    np.savez(path, **flat)


def adamw_state(params, seed=7):
    """AdamW moments three steps in, drawn in numpy: first moments around
    1e-3, second moments in [1e-4, 2e-4] (as
    ``tests/test_torch_lm_train.py`` draws them)."""
    rng = np.random.default_rng(seed)
    flat = dict(tree_leaves(params))
    mu = {"/".join(k): 1e-3 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in flat.items()}
    nu = {"/".join(k): 1e-4 * (1 + rng.random(v.shape)).astype(np.float32)
          for k, v in flat.items()}
    return {"mu": unflatten(mu), "nu": unflatten(nu), "count": np.int32(3)}


def read_out(out):
    """A rank-0 output file as {name: {leaf path: array}} and scalars."""
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    trees = {}
    for k, v in res.items():
        head, _, rest = k.partition("/")
        if rest:
            trees.setdefault(head, {})[tuple(rest.split("/"))] = v
        else:
            trees[head] = float(v)
    return trees


def f32_config(arch, **overrides):
    """The smoke config of ``arch`` in f32 throughout."""
    return dataclasses.replace(C.get_smoke(arch), param_dtype=torch.float32,
                               act_dtype=torch.float32, **overrides)


def unflatten(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for key, leaf in flat.items():
        node, parts = out, key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf
    return out


def load_case(path):
    """(params, opt state, batch) of a case file, as numpy trees."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = unflatten(flat)
    return tree["params"], tree["opt"], tree["batch"]


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _flat_np(tree, prefix):
    return {f"{prefix}/{'/'.join(path)}": _full(t).detach().float().numpy()
            for path, t in tree_leaves(tree)}


# Faults planted in train_step_compressed for the checks that must refuse
# them: the averaged gradients zeroed or negated, the pod all-reduce
# skipped (each pod keeps its own gradient), the parameter update dropped.
PLANTED_FAULTS = ("zeroed", "negated", "no_pod_sum", "no_update")


@contextlib.contextmanager
def planted(fault):
    """``train_step_compressed`` with the planted fault ``fault`` (one of
    :data:`PLANTED_FAULTS`, or ``""`` for none) while the block runs."""
    from repro_torch.models import model
    from repro_torch.optim import compression
    psum, update = compression.psum_compressed, model.adamw_update

    def scaled(by):
        def fn(g, err, group=None):
            mean, new_err = psum(g, err, group)
            return mean * by, new_err
        return fn

    def no_update(grads, state, params, cfg, **kw):
        _, new_state, metrics = update(grads, state, params, cfg, **kw)
        return params, new_state, metrics

    patch = {"zeroed": (compression, "psum_compressed", scaled(0.0)),
             "negated": (compression, "psum_compressed", scaled(-1.0)),
             "no_pod_sum": (compression, "psum_compressed",
                            lambda g, err, group=None: (g, err)),
             "no_update": (model, "adamw_update", no_update)}.get(fault)
    if patch is None:
        yield
        return
    module, name, fn = patch
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, psum if name == "psum_compressed" else update)


def step_case(bundle, path, out, compressed=False, checkpoint=None,
              microbatches=1, count=False):
    """One ``value_and_grad`` and one ``train_step`` (and, if
    ``compressed``, one ``train_step_compressed``, then one with each of
    :data:`PLANTED_FAULTS`) of a case on ``bundle``'s mesh, written by
    rank 0 to ``out``: the loss, every gradient leaf and the new
    parameters, whole (``closs``, ``cnew``, the new first moments ``cmu``
    and ``mu`` of both steps, the new residuals ``err``; ``<fault>_cnew``
    and ``<fault>_cmu`` of the faulted steps).  With ``checkpoint`` (a
    directory) every rank saves the new parameters there as step 1.  With
    ``count``, one more ``train_step`` runs under
    ``repro_torch.launch.cost_analysis``'s counters and rank 0 writes its
    counts to ``out + ".cost.json"``."""
    params, opt, batch = load_case(path)
    params = bundle.shard(lm_params_from_numpy(params, device="cpu"))
    opt = distribute(opt_state_from_numpy(opt, device="cpu"),
                     bundle.opt_shardings())
    batch = bundle.shard_batch({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss, grads = bundle.value_and_grad(params, batch)
    res = {"loss": np.asarray(float(loss))}
    if compressed:
        for fault in ("",) + PLANTED_FAULTS:
            with planted(fault):
                cnew, copt, err, cmetrics = bundle.train_step_compressed(
                    params, opt, init_error_state(params), batch)
            head = f"{fault}_" if fault else ""
            res.update(_flat_np(cnew, head + "cnew"))
            res.update(_flat_np(copt["mu"], head + "cmu"))
            if not fault:
                res["closs"] = np.asarray(float(cmetrics["loss"]))
                res.update(_flat_np(err, "err"))
    new, new_opt, metrics = bundle.train_step(params, opt, batch)
    res["step_loss"] = np.asarray(float(metrics["loss"]))
    res.update(_flat_np(grads, "grad"))
    res.update(_flat_np(new, "new"))
    if compressed:
        res.update(_flat_np(new_opt["mu"], "mu"))
    if microbatches > 1:
        micro, _, _ = bundle.train_step(params, opt, batch,
                                        microbatches=microbatches)
        res.update(_flat_np(micro, "micro"))
    if checkpoint is not None:
        CheckpointManager(checkpoint).save(1, {"params": new}, blocking=True)
    if torch.distributed.get_rank() == 0:
        np.savez(out, **res)
    if count:
        write_cost(out + ".cost.json", bundle.train_step, params, opt, batch)


def write_cost(path, fn, *args):
    """``fn(*args)`` once under ``cost_analysis``'s counters; rank 0
    writes the counts to ``path`` (JSON)."""
    import json
    from repro_torch.kernels import dispatch
    from repro_torch.launch import cost_analysis
    with dispatch.forced_dense():
        _, cost = cost_analysis.run(fn, *args)
    if torch.distributed.get_rank() == 0:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(cost), f)


def run_cases(shape, cases, opt_lr):
    """Rank body: ``cases`` is a list of dicts (``arch``, ``overrides``,
    ``path`` of the case file, ``out`` file, optional ``compressed`` and
    ``checkpoint``) run in order on one mesh of ``shape``."""
    init_distributed("cpu")
    mesh = make_device_mesh(shape, device_type="cpu")
    for case in cases:
        bundle = build(f32_config(case["arch"], **case["overrides"]),
                       OptConfig(lr=opt_lr), mesh=mesh)
        step_case(bundle, case["path"], case["out"],
                  case.get("compressed", False), case.get("checkpoint"),
                  case.get("microbatches", 1), case.get("count", False))


def psum_inputs(pod: int, cell: int, shape=(3, 50)):
    """The gradient and residual that pod ``pod`` of mesh cell ``cell``
    feeds to ``psum_compressed`` (f32, from a numpy seed)."""
    rng = np.random.default_rng(100 * cell + pod)
    g = (rng.standard_normal(shape) * (1 + pod)).astype(np.float32)
    err = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    return g, err


def run_compressed(shape, case, psum_dir, opt_lr):
    """Rank body on a (pod, data, model) mesh, the group joined through a
    file store in ``psum_dir``: ``psum_compressed`` of :func:`psum_inputs`
    over the ``pod`` group (plain tensors; each rank writes its mean and
    residual to ``psum_dir``), then the case's plain and compressed steps
    (:func:`step_case`)."""
    from repro_torch.optim.compression import psum_compressed
    init_distributed("cpu", init_method=f"file://{psum_dir}/store")
    mesh = make_device_mesh(shape, device_type="cpu")
    pod = mesh.get_local_rank("pod")
    cell = torch.distributed.get_rank() % (shape[1] * shape[2])
    g, err = psum_inputs(pod, cell)
    mean, new_err = psum_compressed(torch.from_numpy(g), torch.from_numpy(err),
                                    mesh.get_group("pod"))
    np.savez(f"{psum_dir}/psum_{pod}_{cell}.npz", mean=mean.numpy(),
             err=new_err.numpy())
    bundle = build(f32_config(case["arch"], **case["overrides"]),
                   OptConfig(lr=opt_lr), mesh=mesh)
    step_case(bundle, case["path"], case["out"], compressed=True)


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_SEQ, SERVE_STEPS = 4, 12, 24, 4


def serve_inputs(cfg, seed=3):
    """Numpy inputs of a serving case: tokens (B, prompt + steps), the
    vlm's (3, B, prompt + steps) positions, the encdec's frames."""
    rng = np.random.default_rng(seed)
    n = SERVE_PROMPT + SERVE_STEPS
    out = {"tokens": rng.integers(0, cfg.vocab, (SERVE_BATCH, n)).astype(
        np.int64)}
    if cfg.family == "vlm":
        out["positions"] = rng.integers(0, 64, (3, SERVE_BATCH, n)).astype(
            np.int64)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (SERVE_BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def serve(bundle, params, inputs, start=None):
    """Prefill SERVE_PROMPT tokens into an f32 cache of SERVE_MAX_SEQ
    positions (the encdec: encode the frames and fill every layer's cross
    K/V), then SERVE_STEPS decode steps teacher-forced on the next tokens;
    on ``bundle``'s mesh when it has one.  With ``start`` (a prefilled
    cache as numpy, ``cache_to_numpy``'s layout) the steps decode from it,
    placed by ``cache_shardings``, instead.  Returns (the logits of the
    prefill, if any, and of each step, the final cache's entries), whole,
    as numpy."""
    from repro_torch.convert import cache_from_numpy
    from repro_torch.models import attention, encdec, transformer
    from repro_torch.models.common import assign, slot, unstack
    cfg, mesh = bundle.cfg, bundle.mesh
    tokens = torch.from_numpy(inputs["tokens"])
    pos = (torch.from_numpy(inputs["positions"]) if "positions" in inputs
           else None)
    logits = []
    with torch.no_grad():
        if start is not None:
            cache = cache_from_numpy(start, device="cpu", shardings=(
                None if mesh is None else
                bundle.cache_shardings(SERVE_BATCH, SERVE_MAX_SEQ)))
        elif cfg.family == "encdec":
            enc = bundle.encode_step(params, torch.from_numpy(
                inputs["frames"]))
            cache = encdec.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ,
                                      torch.float32, "cpu", mesh)
            for i, lp in enumerate(unstack(params["dec"])):
                k, v = attention.cross_kv(enc, lp["xattn"], cfg)
                assign(slot(cache["xk"], i), k)
                assign(slot(cache["xv"], i), v)
        else:
            first, cache = transformer.prefill(
                params, cfg, tokens[:, :SERVE_PROMPT], SERVE_MAX_SEQ,
                positions=None if pos is None else pos[..., :SERVE_PROMPT],
                cache_dtype=torch.float32)
            logits.append(first)
        for s in range(SERVE_STEPS):
            t = SERVE_PROMPT + s
            out, cache = bundle.serve_step(
                params, cache, tokens[:, t:t + 1],
                None if pos is None else pos[..., t:t + 1])
            logits.append(out)
    return ([_full(x).numpy() for x in logits],
            {k: _full(v).float().numpy() for k, v in cache.items()
             if k != "index"})


def write_serve(out, logits, cache):
    """Rank 0's serving result file (see :func:`read_serve`)."""
    if torch.distributed.get_rank() == 0:
        flat = {f"logits/{i}": x for i, x in enumerate(logits)}
        flat.update({f"cache/{k}": v for k, v in cache.items()})
        np.savez(out, **flat)


def read_serve(out):
    """(logits list, cache dict) of a :func:`write_serve` file."""
    with np.load(out) as z:
        logits = [z[f"logits/{i}"] for i in range(
            sum(k.startswith("logits/") for k in z.files))]
        cache = {k.split("/", 1)[1]: z[k] for k in z.files
                 if k.startswith("cache/")}
    return logits, cache


def serve_params(case, bundle):
    """A case's numpy parameters onto ``bundle``'s mesh."""
    with np.load(case["path"]) as z:
        flat = {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith("params/")}
    return bundle.shard(lm_params_from_numpy(unflatten(flat), device="cpu"))


def run_serve(shapes, cases):
    """Rank body: each case (``arch``, ``overrides``, ``path`` of a case
    file, ``inputs`` file, ``mesh`` index into ``shapes``, ``out`` file,
    optional ``start`` file of a prefilled numpy cache) served by
    :func:`serve` on its mesh."""
    init_distributed("cpu")
    meshes = [make_device_mesh(s, device_type="cpu") for s in shapes]
    for case in cases:
        bundle = build(f32_config(case["arch"], **case["overrides"]),
                       mesh=meshes[case["mesh"]])
        with np.load(case["inputs"]) as z:
            inputs = {k: z[k] for k in z.files}
        start = None
        if "start" in case:
            with np.load(case["start"]) as z:
                start = {k: z[k] for k in z.files}
        write_serve(case["out"], *serve(bundle, serve_params(case, bundle),
                                         inputs, start))


def run_placements(shapes, layouts, archs, out, small_draw, seed=0):
    """Rank body.  Rank 0 writes to ``out`` (JSON) the port's
    ``cache_shardings(batch, 2112)`` of every architecture of ``archs`` at
    its published shape for each (mesh index into ``shapes``, batch) of
    ``layouts``, one entry per tensor axis: the mesh axes that split it, in
    mesh order.  Every rank checks, on each mesh, that ``init`` equals
    ``distribute(init(seed))`` of the one-device draw on its own shards,
    bit for bit, for each smoke config in f32, with the draw's slicing
    thresholds at the defaults and at ``small_draw`` = (whole, slice)
    bytes; every rank's flag goes into ``out`` too."""
    import json
    from repro_torch.models import common
    init_distributed("cpu")
    meshes = [make_device_mesh(s, device_type="cpu") for s in shapes]
    res = {"placements": {}, "draws": {}}
    for m, batch in layouts:
        names = meshes[m].mesh_dim_names
        for arch in archs:
            bundle = build(C.get(arch), mesh=meshes[m])
            specs = bundle.cache_specs(batch, 2112)
            res["placements"][f"{arch}/{m}/{batch}"] = {
                name: [[names[i] for i, pl in enumerate(ns.placements)
                        if pl.is_shard(dim)]
                       for dim in range(len(specs[name].shape))]
                for name, ns in bundle.cache_shardings(batch, 2112).items()}
    defaults = (common.WHOLE_DRAW_BYTES, common.SLICE_DRAW_BYTES)
    for m, mesh in enumerate(meshes):
        for arch in archs:
            for label, sizes in (("default", defaults),
                                 ("sliced", small_draw)):
                common.WHOLE_DRAW_BYTES, common.SLICE_DRAW_BYTES = sizes
                try:
                    one = build(f32_config(arch)).init(seed, "cpu")
                    sharded = build(f32_config(arch), mesh=mesh)
                    got = sharded.init(seed)
                    want = distribute(one, sharded.param_shardings())
                finally:
                    common.WHOLE_DRAW_BYTES, common.SLICE_DRAW_BYTES = defaults
                same = all(
                    isinstance(a, torch.distributed.tensor.DTensor)
                    and a.placements == b.placements
                    and torch.equal(a.to_local(), b.to_local())
                    for (_, a), (_, b) in zip(tree_leaves(got),
                                              tree_leaves(want)))
                flags = [None] * torch.distributed.get_world_size()
                torch.distributed.all_gather_object(flags, bool(same))
                res["draws"][f"{arch}/{m}/{label}"] = flags
    if torch.distributed.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(res, f)
