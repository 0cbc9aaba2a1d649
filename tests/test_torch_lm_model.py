"""The port's Zamba2 serving path against the JAX reference, on the CPU.

The same parameters (drawn by the reference's ``init`` and converted with
``lm_params_from_numpy``) and the same numpy tokens go through the
reference's ``forward``, ``prefill`` and three ``decode_step`` calls and
through the port's.  On the CPU the port's ``attention`` and ``ssd`` sites
run their plain versions (the kernels are held against those on the card
in ``tests/test_torch_cuda_kernels.py``).  The smoke config uses
``ssm_chunk=16``, so the 40-token prompt spans three SSD chunks, the last
one ragged.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.launch.mesh import make_host_mesh, use_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import P_ as RP_  # noqa: E402
from repro.models.model import build as rbuild  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import (cache_from_numpy,  # noqa: E402
                                 cache_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "zamba2-2.7b"
PROMPT, DECODE = 40, 3
# f32: the same f32 arithmetic in another order (matmul blocking, online vs
# one-shot softmax, chunked scan sums) — rounding, well below 1e-4.
# bf16: both sides round activations to bf16 at different points (XLA may
# keep f32 inside a fusion; the port rounds after each op), so logits differ
# at the level of a few bf16 ulps.  The largest part is silu: the reference
# rounds each op of its expansion x * 1 / (1 + exp(-x)) to bf16, the port's
# fused ``F.silu`` rounds once.  Measured on the CPU: 1.1e-2 to 1.7e-2 of
# the logits (5e-3 to 7e-3 with the reference's expansion, which costs the
# served path four more elementwise passes per call).
TOL = {"f32": 1e-4, "bf16": 2e-2}
CACHE_KEYS = ("k", "v", "ssm_h", "ssm_conv", "index")


def _configs(precision):
    jcfg = dataclasses.replace(RC.get_smoke(ARCH), ssm_chunk=16)
    tcfg = dataclasses.replace(C.get_smoke(ARCH), ssm_chunk=16)
    if precision == "f32":
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                   act_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.float32,
                                   act_dtype=torch.float32)
    return jcfg, tcfg


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def runs(request):
    """Reference and port outputs for one precision, computed once."""
    precision = request.param
    jcfg, tcfg = _configs(precision)
    # f32 compares caches in f32 (a rounding comparison); bf16 keeps the
    # default bf16 cache of both packages.
    jcache, tcache = ((jnp.float32, torch.float32) if precision == "f32"
                      else (jnp.bfloat16, torch.bfloat16))
    tokens = np.random.default_rng(11).integers(
        0, jcfg.vocab, size=(2, PROMPT + DECODE)).astype(np.int32)
    mesh = make_host_mesh()
    jparams = rbuild(jcfg, mesh).init(jax.random.PRNGKey(0))
    ref = {"decode": []}
    with use_mesh(mesh):
        fwd = jax.jit(lambda p, t: RT.forward(p, jcfg, mesh, t))
        pre = jax.jit(lambda p, t: RT.prefill(p, jcfg, mesh, t, PROMPT + DECODE,
                                              cache_dtype=jcache))
        dec = jax.jit(lambda p, c, t: RT.decode_step(p, jcfg, mesh, c, t))
        ref["forward"] = np.asarray(fwd(jparams, tokens[:, :PROMPT]), np.float32)
        logits, cache = pre(jparams, tokens[:, :PROMPT])
        ref["prefill"] = np.asarray(logits, np.float32)
        ref["cache"] = {k: np.asarray(v, np.float32) for k, v in cache.items()}
        ref["cache_arrays"] = jax.tree_util.tree_map(np.asarray, cache)
        for t in range(DECODE):
            logits, cache = dec(jparams, cache,
                                tokens[:, PROMPT + t:PROMPT + t + 1])
            ref["decode"].append(np.asarray(logits, np.float32))

    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ttok = torch.from_numpy(tokens)
    port = {"decode": [], "params": params, "cfg": tcfg, "tokens": ttok}
    with torch.no_grad():
        port["forward"] = T.forward(params, tcfg, ttok[:, :PROMPT]).float()
        logits, cache = T.prefill(params, tcfg, ttok[:, :PROMPT],
                                  PROMPT + DECODE, cache_dtype=tcache)
        port["prefill"] = logits.float()
        port["cache"] = cache_to_numpy(cache)
        for t in range(DECODE):
            logits, cache = T.decode_step(params, tcfg, cache,
                                          ttok[:, PROMPT + t:PROMPT + t + 1])
            port["decode"].append(logits.float())
    return precision, ref, port, jparams


def test_forward_logits_match_reference(runs):
    precision, ref, port, _ = runs
    assert port["forward"].shape == ref["forward"].shape == (2, PROMPT, 256)
    assert _rel(port["forward"], ref["forward"]) <= TOL[precision]


def test_prefill_logits_match_reference(runs):
    precision, ref, port, _ = runs
    assert port["prefill"].shape == (2, 256)
    assert _rel(port["prefill"], ref["prefill"]) <= TOL[precision]


@pytest.mark.parametrize("key", CACHE_KEYS)
def test_prefill_cache_matches_reference(runs, key):
    precision, ref, port, _ = runs
    got, want = port["cache"][key], ref["cache"][key]
    assert np.shape(got) == np.shape(want)
    if key == "index":
        assert int(got) == int(want) == PROMPT
    else:
        assert _rel(got, want) <= TOL[precision]


@pytest.mark.parametrize("step", range(DECODE))
def test_decode_logits_match_reference(runs, step):
    precision, ref, port, _ = runs
    assert _rel(port["decode"][step], ref["decode"][step]) <= TOL[precision]


def test_decode_from_the_reference_cache(runs):
    """The reference's prefill cache, converted by ``cache_from_numpy``,
    decodes in the port as it does in the reference."""
    precision, ref, port, _ = runs
    cache = cache_from_numpy(ref["cache_arrays"], device="cpu")
    assert cache["index"] == PROMPT
    assert cache["k"].dtype == (torch.float32 if precision == "f32"
                                else torch.bfloat16)
    with torch.no_grad():
        logits, _ = T.decode_step(port["params"], port["cfg"], cache,
                                  port["tokens"][:, PROMPT:PROMPT + 1])
    assert _rel(logits.float(), ref["decode"][0]) <= TOL[precision]


def test_params_round_trip_key_for_key(runs):
    _, _, port, jparams = runs
    back = lm_params_to_numpy(port["params"])
    want = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    got = dict(tree_leaves(back))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], np.asarray(want[path],
                                                            np.float32))


def test_full_config_matches_reference_field_by_field():
    want, got = RC.get(ARCH), C.get(ARCH)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        w, g = getattr(want, name), getattr(got, name)
        if name in ("param_dtype", "act_dtype"):
            assert str(g).replace("torch.", "") == np.dtype(w).name, name
        else:
            assert g == w, name
    assert (got.d_inner, got.ssm_heads) == (want.d_inner, want.ssm_heads)


def test_full_lm_specs_shapes_match_reference():
    """Shapes and inits of every leaf at the published width (nothing is
    allocated)."""
    want = jax.tree_util.tree_flatten_with_path(
        RT.lm_specs(RC.get(ARCH)), is_leaf=lambda x: isinstance(x, RP_))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init) for path, s in want}
    got = {path: (s.shape, s.init)
           for path, s in tree_leaves(build(C.get(ARCH)).specs)}
    assert got == want
    n_params = sum(int(np.prod(s)) for s, _ in got.values())
    assert 2.0e9 < n_params < 2.2e9


@pytest.mark.parametrize("name", ["granite-8b", "qwen3-4b", "smollm-360m",
                                  "deepseek-coder-33b", "mamba2-2.7b",
                                  "qwen3-moe-30b-a3b", "arctic-480b",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_ported_architectures_resolve(name):
    """Every architecture the reference serves resolves to its published
    config, of the reference's family."""
    assert C.get(name).name == name
    assert C.get(name).family == RC.get(name).family
    assert sorted(RC.ARCHS) == sorted(C.ARCHS) == sorted(C._MODULES)


def test_unknown_architecture_raises():
    with pytest.raises(KeyError, match="unknown architecture"):
        C.get("gpt-2")


def test_init_params_draws_a_large_leaf_slice_by_slice(monkeypatch):
    """A leaf above ``WHOLE_DRAW_BYTES`` of f32 is drawn in slices of its
    leading axis of at most ``SLICE_DRAW_BYTES``, in order, straight into
    its tensor; a leaf under it is drawn whole, as before."""
    monkeypatch.setattr(common, "WHOLE_DRAW_BYTES", 4 * 6 * 40 * 30)
    monkeypatch.setattr(common, "SLICE_DRAW_BYTES", 4 * 3 * 40 * 30)
    specs = {"big": common.P_((7, 40, 30)), "small": common.P_((6, 40, 30),
                                                                init="small")}
    draws = []
    real = torch.randn

    def randn(shape, **kw):
        draws.append(tuple(shape))
        return real(shape, **kw)

    monkeypatch.setattr(torch, "randn", randn)
    got = common.init_params(specs, torch.Generator().manual_seed(5),
                             torch.bfloat16, device="cpu")
    # sorted-key order: "big" in slices of 3, 3 and 1 rows, then "small"
    assert draws == [(3, 40, 30), (3, 40, 30), (1, 40, 30), (6, 40, 30)]
    assert got["big"].shape == (7, 40, 30) and got["big"].dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    want = torch.cat([real((n, 40, 30), generator=gen) * 0.02
                      for n in (3, 3, 1)]).to(torch.bfloat16)
    assert torch.equal(got["big"], want)
    assert torch.equal(got["small"],
                       (real((6, 40, 30), generator=gen) * 0.006
                        ).to(torch.bfloat16))
    assert abs(got["big"].float().std().item() - 0.02) < 1e-3


def test_decode_past_a_full_cache_raises():
    """The reference's ``prefill_step`` sizes the cache to the prompt and
    its next decode clamps the write onto the last slot; the port raises."""
    _, tcfg = _configs("f32")
    bundle = build(tcfg)
    params = bundle.init(0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with torch.no_grad():
        _, cache = bundle.prefill_step(params, tokens)
        with pytest.raises(ValueError, match="past its end"):
            bundle.serve_step(params, cache, tokens[:, :1])
