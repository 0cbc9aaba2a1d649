"""Sharded LM serving of the port (``build(cfg, mesh=...)``: the decode
cache placed by ``cache_shardings``, prefill and decode on DTensors)
against one device and against the reference, on the CPU.

Ranks are spawned processes of one thread each over gloo; one 4-rank
spawn serves every case, on a (data 2, model 2) and a (data 1, model 4)
DeviceMesh.  Every smoke architecture in f32, from the same numpy
parameters and tokens: a 12-token prefill into a 24-position f32 cache
(the encdec: its frames encoded and every layer's cross K/V filled), then
4 decode steps, teacher-forced; on each mesh against the port's
``mesh=None`` run here, the logits of the prefill and of each step within
1e-5 relative and every cache entry within 1e-5.  The smoke configs have
2 KV heads, so on (1, 4) every KV cache (and the encdec's cross K/V) is
split along its sequence and decode attention combines the ranks'
partial softmax statistics; on (2, 2) the heads are split.  The MoEs run
at capacity factor 16, where nothing drops (an expert's capacity comes
from a data shard's tokens).

A prefilled cache converted from numpy onto each mesh
(``cache_from_numpy`` with ``cache_shardings``, as a reference's cache
would come) decodes the same 4 steps within 1e-5 of one device, for one
model of each decoder-only family.

The ``expert_tp`` MoE: qwen3-moe-30b-a3b's smoke config on (2, 2) at its
default capacity factor against the reference's own ``expert_tp`` run on
4 fake XLA devices in a subprocess (the tokens gathered over ``data``, so
the capacity and the drops are the reference's), logits within 1e-5
relative; and at capacity factor 16 against ``fsdp_gather`` on the same
mesh, within 1e-5.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import (cache_to_numpy,  # noqa: E402
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SHAPES = ((2, 2), (1, 4))
LOGIT_TOL, CACHE_TOL = 1e-5, 1e-5
MOE = ("qwen3-moe-30b-a3b", "arctic-480b")
TP_ARCH = "qwen3-moe-30b-a3b"
# one of each decoder-only family, decoded from a converted cache
START_ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "qwen2-vl-72b",
               "mamba2-2.7b", "zamba2-2.7b")
STEPS = ranks.SERVE_STEPS + 1          # the prefill and each decode step
# Without JAX (a host with the port alone) the reference's half skips
HAVE_JAX = importlib.util.find_spec("jax") is not None

REFERENCE_TP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import transformer
from repro.models.model import build

case, inputs, out, prompt, max_seq, steps = sys.argv[1:7]
prompt, max_seq, steps = int(prompt), int(max_seq), int(steps)
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
with np.load(inputs) as z:
    tokens = jnp.asarray(z["tokens"], jnp.int32)
mesh = make_mesh((2, 2), ("data", "model"))
cfg = dataclasses.replace(configs.get_smoke("qwen3-moe-30b-a3b"),
                          param_dtype=jnp.float32, act_dtype=jnp.float32,
                          moe_impl="expert_tp")
bundle = build(cfg, mesh)
params = jax.device_put(params, bundle.param_shardings())
with use_mesh(mesh):
    first, cache = jax.jit(lambda p, t: transformer.prefill(
        p, cfg, mesh, t, max_seq, cache_dtype=jnp.float32))(
            params, tokens[:, :prompt])
    logits = [first]
    step = jax.jit(bundle.serve_step)
    for s in range(steps):
        t = prompt + s
        out_s, cache = step(params, cache, tokens[:, t:t + 1])
        logits.append(out_s)
np.savez(out, **{f"logits/{i}": np.asarray(x) for i, x in enumerate(logits)})
"""


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _overrides(arch):
    return {"capacity_factor": 16.0} if arch in MOE else {}


def _write(tmp, name, params, inputs):
    path, inp = tmp / f"{name}.npz", tmp / f"{name}.inputs.npz"
    ranks.write_case(path, params, {}, {})
    np.savez(inp, **inputs)
    return str(path), str(inp)


def _prefilled(cfg, params, inputs):
    """The one-device f32 cache after the prefill, as numpy."""
    pos = inputs.get("positions")
    _, cache = transformer.prefill(
        lm_params_from_numpy(params, device="cpu"), cfg,
        torch.from_numpy(inputs["tokens"][:, :ranks.SERVE_PROMPT]),
        ranks.SERVE_MAX_SEQ,
        positions=None if pos is None else torch.from_numpy(
            pos[..., :ranks.SERVE_PROMPT]),
        cache_dtype=torch.float32)
    return cache_to_numpy(cache)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{(arch, mesh index) or a label: (sharded result, one-device result
    or the reference's)}, every sharded case in one 4-rank spawn."""
    tmp = tmp_path_factory.mktemp("serve")
    cases, single = [], {}
    for arch in C.ARCHS:
        cfg = ranks.f32_config(arch, **_overrides(arch))
        params = lm_params_to_numpy(build(cfg).init(0, "cpu"))
        inputs = ranks.serve_inputs(cfg)
        path, inp = _write(tmp, arch, params, inputs)
        for m in range(len(SHAPES)):
            cases.append({"arch": arch, "overrides": _overrides(arch),
                          "path": path, "inputs": inp, "mesh": m,
                          "out": str(tmp / f"{arch}.{m}.out.npz"),
                          "key": (arch, m)})
        single[arch] = (cfg, params, inputs)
        if arch in START_ARCHS:
            start = str(tmp / f"{arch}.start.npz")
            np.savez(start, **_prefilled(cfg, params, inputs))
            for m in range(len(SHAPES)):
                cases.append({"arch": arch, "overrides": _overrides(arch),
                              "path": path, "inputs": inp, "mesh": m,
                              "start": start,
                              "out": str(tmp / f"{arch}.{m}.start.npz"),
                              "key": ("start", arch, m)})
    # expert_tp at the default capacity (against the reference) and at
    # capacity factor 16 (against fsdp_gather)
    tp_cfg = ranks.f32_config(TP_ARCH)
    tp_params = lm_params_to_numpy(build(tp_cfg).init(1, "cpu"))
    tp_inputs = ranks.serve_inputs(tp_cfg, seed=4)
    tp_path, tp_inp = _write(tmp, "expert_tp", tp_params, tp_inputs)
    base = next(c for c in cases if c["key"] == (TP_ARCH, 0))
    for label, overrides, path, inp in (
            ("expert_tp", {"moe_impl": "expert_tp"}, tp_path, tp_inp),
            ("expert_tp_16", {"moe_impl": "expert_tp",
                              "capacity_factor": 16.0},
             base["path"], base["inputs"])):
        cases.append({"arch": TP_ARCH, "overrides": overrides, "path": path,
                      "inputs": inp, "mesh": 0,
                      "out": str(tmp / f"{label}.out.npz"), "key": label})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    script = tmp / "reference.py"
    script.write_text(REFERENCE_TP)
    reference = None if not HAVE_JAX else subprocess.Popen(
        [sys.executable, str(script), tp_path, tp_inp,
         str(tmp / "ref.npz"), str(ranks.SERVE_PROMPT),
         str(ranks.SERVE_MAX_SEQ), str(ranks.SERVE_STEPS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    join = ranks.spawn_in_background(ranks.run_serve, 4, (SHAPES, [
        {k: v for k, v in c.items() if k != "key"} for c in cases]))
    one = {arch: ranks.serve(build(cfg), lm_params_from_numpy(
        params, device="cpu"), inputs)
        for arch, (cfg, params, inputs) in single.items()}
    ref = None
    if reference is not None:
        _, err = reference.communicate()
        assert reference.returncode == 0, err[-3000:]
        ref = ranks.read_serve(tmp / "ref.npz")[0]
    join()
    got = {c["key"]: ranks.read_serve(c["out"]) for c in cases}
    return got, one, ref


@pytest.mark.parametrize("mesh", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_sharded_logits_match_one_device(served, arch, mesh):
    got, one, _ = served
    logits, want = got[(arch, mesh)][0], one[arch][0]
    assert len(logits) == len(want)
    for i, (a, b) in enumerate(zip(logits, want)):
        assert np.isfinite(a).all()
        assert _rel(a, b) <= LOGIT_TOL, (i, _rel(a, b))


@pytest.mark.parametrize("mesh", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_sharded_cache_matches_one_device(served, arch, mesh):
    got, one, _ = served
    cache, want = got[(arch, mesh)][1], one[arch][1]
    assert set(cache) == set(want)
    for k, w in want.items():
        assert cache[k].shape == w.shape, k
        assert np.max(np.abs(cache[k] - w)) <= CACHE_TOL, k


@pytest.mark.parametrize("mesh", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
@pytest.mark.parametrize("arch", START_ARCHS)
def test_decode_from_converted_cache_matches_one_device(served, arch, mesh):
    got, one, _ = served
    logits, want = got[("start", arch, mesh)][0], one[arch][0][1:]
    assert len(logits) == len(want) == ranks.SERVE_STEPS
    for i, (a, b) in enumerate(zip(logits, want)):
        assert _rel(a, b) <= LOGIT_TOL, (i, _rel(a, b))


@pytest.mark.parametrize("step", range(STEPS))
def test_expert_tp_matches_reference_expert_tp(served, step):
    got, _, ref = served
    if ref is None:
        pytest.skip("the reference needs JAX")
    assert _rel(got["expert_tp"][0][step], ref[step]) <= LOGIT_TOL


@pytest.mark.parametrize("step", range(STEPS))
def test_expert_tp_matches_fsdp_gather_where_nothing_drops(served, step):
    got = served[0]
    assert _rel(got["expert_tp_16"][0][step],
                got[(TP_ARCH, 0)][0][step]) <= LOGIT_TOL
