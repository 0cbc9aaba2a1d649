"""Sharded LM training of the port (``build(cfg, mesh=...)``, DTensor
placements from the reference's rules) against one device, on the CPU.

Ranks are spawned processes of one thread each over gloo
(``repro_torch.launch.mesh.spawn_ranks``); one 4-rank spawn serves every
case.  The same numpy parameters, AdamW state (three steps in) and batch
go through the sharded step on (data 2, model 2) and through the port's
``mesh=None`` step here, for every smoke architecture in f32: the loss
within 1e-5 relative, each gradient leaf within 1e-4 relative (Frobenius)
and the new parameters within 1e-5.  smollm-360m's, from the reference's
own ``init``, is also held against the reference's single-device
``value_and_grad`` and ``train_step`` at the same bounds, and its new
parameters, saved by the four ranks, restore onto one device bit for bit.
qwen2-vl-72b's step with ``microbatches=2`` (its (3, B, S) positions split
on their axis 1) is held to the one-device step with two microbatches.

The dry-run counts what the ranks run: for zamba2-2.7b (attention, Mamba2
blocks and all-to-alls in one step) the four ranks count one more
``train_step`` with ``launch.cost_analysis``, and the same step of a fake
(2, 2) world in this process (``launch.dryrun``, fake tensors) must give
rank 0's flops, collective bytes and ops per kind and argument bytes
exactly; its bytes accessed and temporaries are printed beside rank 0's
(a real collective's output lives until its wait).

The two MoE architectures run here at capacity factor 16, where no
assignment drops: an expert's capacity comes from the tokens of one data
shard (the reference's semantics), so at the default 1.25 a data-sharded
step drops other assignments than one device does.
``tests/test_torch_lm_sharded_moe.py`` holds the default against the
reference's own sharded run.
"""
import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, opt_state_from_numpy)
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402

B, S = 4, 16
LR = 1e-2
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5
MOE = ("qwen3-moe-30b-a3b", "arctic-480b")
MICRO_ARCH = "qwen2-vl-72b"
COUNTED = ("zamba2-2.7b",)
# Without JAX (a host with the port alone) the reference's halves skip
HAVE_JAX = importlib.util.find_spec("jax") is not None


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _overrides(arch):
    return {"capacity_factor": 16.0} if arch in MOE else {}


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["positions"] = rng.integers(0, 64, (3, B, S)).astype(np.int32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _single(cfg, params, opt, batch, microbatches=1):
    """The port's mesh=None loss, gradients and new parameters (of a step
    of ``microbatches``)."""
    bundle = build(cfg, OptConfig(lr=LR))
    tp = lm_params_from_numpy(params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = bundle.value_and_grad(tp, tb)
    new, _, _ = bundle.train_step(
        tp, opt_state_from_numpy(opt, device="cpu"), tb,
        microbatches=microbatches)
    return (float(loss), dict(tree_leaves(lm_params_to_numpy(grads))),
            dict(tree_leaves(lm_params_to_numpy(new))))


def _reference_smollm():
    """smollm-360m's f32 smoke parameters from the reference's ``init``
    (as numpy), and a function that takes the reference's single-device
    loss, gradients and new parameters from them (its ``train_step`` with
    one microbatch: ``value_and_grad`` of ``loss_fn``, then
    ``adamw_update``)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as RC
    from repro.launch.mesh import make_host_mesh, use_mesh
    from repro.models.model import build as rbuild
    from repro.optim.adamw import OptConfig as ROptConfig, adamw_update
    jcfg = dataclasses.replace(RC.get_smoke("smollm-360m"),
                               param_dtype=jnp.float32, act_dtype=jnp.float32)
    mesh = make_host_mesh()
    rb = rbuild(jcfg, mesh, opt_cfg=ROptConfig(lr=LR))
    jparams = rb.init(jax.random.PRNGKey(0))

    def step(opt, batch):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with use_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(rb.loss_fn))(jparams, jb)
            new, _, _ = jax.jit(adamw_update, static_argnums=3)(
                grads, jax.tree_util.tree_map(jnp.asarray, opt), jparams,
                rb.opt_cfg)
        as_np = lambda tree: dict(tree_leaves(  # noqa: E731
            jax.tree_util.tree_map(np.asarray, tree)))
        return float(loss), as_np(grads), as_np(new)
    return jax.tree_util.tree_map(np.asarray, jparams), step


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """Every smoke architecture's sharded step on (data 2, model 2) in one
    4-rank spawn, beside the port's mesh=None step (and the reference's
    for smollm-360m, whose new parameters the ranks also checkpoint)."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases, inputs = [], {}
    for arch in C.ARCHS:
        cfg = ranks.f32_config(arch, **_overrides(arch))
        case = {"arch": arch, "overrides": _overrides(arch),
                "path": str(tmp / f"{arch}.npz"),
                "out": str(tmp / f"{arch}.out.npz")}
        if arch == "smollm-360m":
            case["checkpoint"] = str(tmp / "ckpt")
        if arch == "smollm-360m" and HAVE_JAX:
            params, reference_step = _reference_smollm()
        else:
            params = lm_params_to_numpy(build(cfg).init(0, "cpu"))
        if arch == MICRO_ARCH:
            case["microbatches"] = 2
        if arch in COUNTED:
            case["count"] = True
        inputs[arch] = (cfg, params, ranks.adamw_state(params), _batch(cfg))
        ranks.write_case(case["path"], *inputs[arch][1:])
        cases.append(case)
    join = ranks.spawn_in_background(ranks.run_cases, 4,
                                     ((2, 2), cases, LR))
    single = {arch: _single(*args) for arch, args in inputs.items()}
    single["fake"] = {arch: _fake_world_cell(arch) for arch in COUNTED}
    single["micro"] = _single(*inputs[MICRO_ARCH], microbatches=2)
    reference = (reference_step(*inputs["smollm-360m"][2:]) if HAVE_JAX
                 else None)
    join()
    got = {c["arch"]: ranks.read_out(c["out"]) for c in cases}
    for c in cases:
        if c.get("count"):
            got[c["arch"]]["cost_path"] = c["out"] + ".cost.json"
    return got, single, reference, tmp / "ckpt"


def _fake_world_cell(arch):
    """The dry-run's row of the cases' step (B x S tokens, f32 smoke
    config) on a fake (2, 2) world in this process."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    dryrun._quiet_dtensor_warnings()
    try:
        return dryrun.run_lm_cell(
            arch, "smoke_train", False, verbose=False, mesh_shape=(2, 2),
            seq=S, batch=B, config=ranks.f32_config(arch, **_overrides(arch)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _check(got, loss, grads, new):
    assert abs(got["loss"] - loss) <= LOSS_TOL * abs(loss)
    assert set(got["grad"]) == set(grads)
    for k in grads:
        assert _rel(got["grad"][k], grads[k]) <= GRAD_TOL, k
    for k in new:
        assert np.max(np.abs(got["new"][k] - new[k])) <= PARAM_TOL, k


@pytest.mark.parametrize("arch", C.ARCHS)
def test_2x2_step_matches_one_device(mesh_2x2, arch):
    got, single, _, _ = mesh_2x2
    assert got[arch]["step_loss"] == got[arch]["loss"]
    _check(got[arch], *single[arch])


def test_2x2_smollm_matches_reference_single_device(mesh_2x2):
    got, _, reference, _ = mesh_2x2
    if reference is None:
        pytest.skip("the reference needs JAX")
    _check(got["smollm-360m"], *reference)


def test_2x2_microbatches_match_one_device(mesh_2x2):
    got, single, _, _ = mesh_2x2
    micro, want = got[MICRO_ARCH]["micro"], single["micro"][2]
    assert set(micro) == set(want)
    for k in want:
        assert np.max(np.abs(micro[k] - want[k])) <= PARAM_TOL, k
    # two microbatches are not one batch: the check sees the split
    assert any(np.max(np.abs(micro[k] - got[MICRO_ARCH]["new"][k])) > 0
               for k in want)


def test_2x2_checkpoint_restores_on_one_device_bit_for_bit(mesh_2x2):
    got, _, _, ckpt = mesh_2x2
    new = got["smollm-360m"]["new"]
    restored = CheckpointManager(ckpt).restore(
        1, {"params/" + "/".join(k): v.shape for k, v in new.items()}, "cpu")
    assert len(restored) == len(new)
    for k, v in new.items():
        t = restored["params/" + "/".join(k)]
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), v)


@pytest.mark.parametrize("arch", COUNTED)
def test_2x2_fake_world_counts_equal_rank_0(mesh_2x2, arch):
    import json
    _, single, _, _ = mesh_2x2
    with open(mesh_2x2[0][arch]["cost_path"]) as f:
        real = json.load(f)
    fake = single["fake"][arch]
    assert fake["status"] == "ok"
    assert fake["per_device_flops"] == real["flops"] > 0
    assert fake["collective_detail"] == real["collective_bytes"]
    assert fake["collective_counts"] == real["collective_counts"]
    assert fake["arg_bytes_per_device"] == real["arg_bytes"]
    # printed, not held: a real collective's output lives until its wait
    print(f"{arch}: bytes accessed fake {fake['per_device_bytes']:.0f}, "
          f"rank 0 {real['bytes_accessed']:.0f}; temporaries fake "
          f"{fake['temp_bytes_per_device']:.0f}, rank 0 "
          f"{real['temp_bytes']:.0f}")
    if arch == "zamba2-2.7b":
        assert real["collective_counts"]["all-to-all"] > 0
