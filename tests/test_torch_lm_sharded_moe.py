"""The port's expert-parallel MoE (``moe_apply`` on a mesh, a
``local_map`` over the reference's ``shard_map`` specs) on a 2x4 mesh,
against the reference's own 2x4 run, on the CPU.

qwen3-moe-30b-a3b's smoke config in f32 at its default capacity factor
(1.25): each data shard routes its own tokens, so the 2x4 step drops other
assignments than one device does.  The reference runs on 8 fake XLA
devices in a subprocess (as ``tests/test_fault_tolerance.py`` runs its 2x4
MoE), the port on 8 gloo ranks of one thread, concurrently, from the same
numpy parameters and batch.  With the same mesh the routes and drops are
the same, so the loss is held to 1e-5 relative and each gradient leaf to
1e-4 relative (Frobenius); against the port's one-device step the loss is
held to the reference's own 5e-2.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCH = "qwen3-moe-30b-a3b"
B, S = 4, 32
LOSS_TOL, GRAD_TOL, SINGLE_TOL = 1e-5, 1e-4, 5e-2
# Without JAX (a host with the port alone) the reference's halves skip
HAVE_JAX = importlib.util.find_spec("jax") is not None

REFERENCE_2X4 = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch.mesh import make_mesh, use_mesh
from repro.models.model import build

case, out = sys.argv[1], sys.argv[2]
with np.load(case) as z:
    flat = {k: z[k] for k in z.files}
params = {}
for key, leaf in flat.items():
    head, *rest = key.split("/")
    if head != "params":
        continue
    node = params
    for k in rest[:-1]:
        node = node.setdefault(k, {})
    node[rest[-1]] = jnp.asarray(leaf)
mesh = make_mesh((2, 4), ("data", "model"))
cfg = dataclasses.replace(configs.get_smoke("qwen3-moe-30b-a3b"),
                          param_dtype=jnp.float32, act_dtype=jnp.float32)
bundle = build(cfg, mesh)
params = jax.device_put(params, bundle.param_shardings())
batch = {k: jax.device_put(jnp.asarray(flat["batch/" + k]),
                           bundle.batch_sharding())
         for k in ("tokens", "labels")}
with use_mesh(mesh):
    loss, grads = jax.jit(jax.value_and_grad(bundle.loss_fn))(params, batch)
res = {"loss": np.asarray(float(loss))}
for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
    res["grad/" + "/".join(p.key for p in path)] = np.asarray(leaf)
np.savez(out, **res)
"""


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def moe_2x4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    cfg = ranks.f32_config(ARCH)
    params = lm_params_to_numpy(build(cfg).init(0, "cpu"))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    case = tmp / "case.npz"
    ranks.write_case(case, params, ranks.adamw_state(params), batch)
    script = tmp / "reference.py"
    script.write_text(REFERENCE_2X4)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    reference = None if not HAVE_JAX else subprocess.Popen(
        [sys.executable, str(script), str(case), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = tmp / "port.npz"
    join = ranks.spawn_in_background(ranks.run_cases, 8, ((2, 4), [
        {"arch": ARCH, "overrides": {}, "path": str(case), "out": str(out)}],
        1e-2))
    single, _ = build(cfg).value_and_grad(
        lm_params_from_numpy(params, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    ref = None
    if reference is not None:
        _, err = reference.communicate()
        assert reference.returncode == 0, err[-3000:]
    join()
    if reference is not None:
        ref = ranks.read_out(tmp / "ref.npz")
    return ranks.read_out(out), ref, float(single)


def _reference(moe_2x4):
    if moe_2x4[1] is None:
        pytest.skip("the reference needs JAX")
    return moe_2x4[:2]


def test_2x4_moe_loss_matches_reference_2x4(moe_2x4):
    got, ref = _reference(moe_2x4)
    assert abs(got["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])


def test_2x4_moe_gradients_match_reference_2x4(moe_2x4):
    got, ref = _reference(moe_2x4)
    assert set(got["grad"]) == set(ref["grad"])
    for k, want in ref["grad"].items():
        assert _rel(got["grad"][k], want) <= GRAD_TOL, k


def test_2x4_moe_loss_near_one_device(moe_2x4):
    got, _, single = moe_2x4
    assert abs(got["loss"] - single) <= SINGLE_TOL * max(abs(single), 1.0)
