"""The port's dense and ssm serving paths against the JAX reference, on the
CPU.

The same parameters (drawn by the reference's ``init`` and converted with
``lm_params_from_numpy``) and the same numpy tokens go through the
reference's ``forward``, ``prefill`` and three ``decode_step`` calls and
through the port's, for ``qwen3-4b`` (qk-norm, rope theta 1e6),
``granite-8b``, ``mamba2-2.7b`` and a ``smollm-360m`` variant with 6 query
heads over 2 KV heads (smollm's GQA group of 3).  On the CPU the port's
``attention`` and ``ssd`` sites run their plain versions.  The smoke configs
use ``ssm_chunk=16``, so the 40-token prompt spans three SSD chunks, the
last one ragged.  At the published widths the configs and parameter specs
of all five dense and ssm architectures are held against the reference's
(nothing is allocated), and the attention layer at qwen3-4b's head shape.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.launch.mesh import make_host_mesh, use_mesh  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import common as RCM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import build as rbuild  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import (cache_from_numpy,  # noqa: E402
                                 cache_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import apply_rope, tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

PROMPT, DECODE = 40, 3
# The tolerances of tests/test_torch_lm_model.py, for the same reasons: f32
# is the same arithmetic in another order; in bf16 both sides round
# activations at different points (the largest part is silu, expanded and
# rounded per op by the reference, fused by the port).
TOL = {"f32": 1e-4, "bf16": 2e-2}
CACHE_KEYS = ("k", "v", "ssm_h", "ssm_conv", "index")
# case -> (architecture, overrides of its smoke config)
CASES = {
    "qwen3-4b": ("qwen3-4b", {}),
    "granite-8b": ("granite-8b", {}),
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    "smollm-gqa3": ("smollm-360m", {"n_heads": 6, "n_kv_heads": 2}),
}
# Parameters of the published configs, counted from the reference's specs.
PARAMS = {
    "qwen3-4b": 4_411_424_256,
    "granite-8b": 8_254_689_280,
    "smollm-360m": 409_007_040,
    "deepseek-coder-33b": 33_342_991_360,
    "mamba2-2.7b": 2_830_951_936,
}


def _configs(arch, overrides, precision):
    jcfg = dataclasses.replace(RC.get_smoke(arch), ssm_chunk=16, **overrides)
    tcfg = dataclasses.replace(C.get_smoke(arch), ssm_chunk=16, **overrides)
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


@pytest.fixture(scope="module",
                params=[(c, p) for c in CASES for p in ("f32", "bf16")],
                ids=lambda cp: f"{cp[0]}-{cp[1]}")
def runs(request):
    """Reference and port outputs for one case and precision, computed
    once."""
    case, precision = request.param
    arch, overrides = CASES[case]
    jcfg, tcfg = _configs(arch, overrides, precision)
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
    """Every key of the reference's cache, and no other: ``k``/``v`` for
    dense, ``ssm_h``/``ssm_conv`` for ssm."""
    precision, ref, port, _ = runs
    assert (key in port["cache"]) == (key in ref["cache"])
    if key not in ref["cache"]:
        return
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
    assert cache.keys() == ref["cache_arrays"].keys()
    assert cache["index"] == PROMPT
    with torch.no_grad():
        logits, _ = T.decode_step(port["params"], port["cfg"], cache,
                                  port["tokens"][:, PROMPT:PROMPT + 1])
    assert _rel(logits.float(), ref["decode"][0]) <= TOL[precision]


def test_cache_round_trip_key_for_key(runs):
    _, ref, _, _ = runs
    arrays = ref["cache_arrays"]
    back = cache_to_numpy(cache_from_numpy(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for key, want in arrays.items():
        np.testing.assert_array_equal(back[key], np.asarray(want, np.float32)
                                      if key != "index" else want)


def test_params_round_trip_key_for_key(runs):
    _, _, port, jparams = runs
    back = lm_params_to_numpy(port["params"])
    want = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    got = dict(tree_leaves(back))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], np.asarray(want[path],
                                                            np.float32))


# ---------------------------------------------------------------------------
# Published widths: configs and specs (nothing allocated)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_full_config_matches_reference_field_by_field(arch):
    want, got = RC.get(arch), C.get(arch)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        w, g = getattr(want, name), getattr(got, name)
        if name in ("param_dtype", "act_dtype"):
            assert str(g).replace("torch.", "") == np.dtype(w).name, name
        else:
            assert g == w, name
    if got.family == "ssm":
        assert (got.d_inner, got.ssm_heads) == (want.d_inner, want.ssm_heads)


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_full_lm_specs_match_reference(arch):
    """Shapes and inits of every leaf, and the parameter count."""
    want = jax.tree_util.tree_flatten_with_path(
        RT.lm_specs(RC.get(arch)), is_leaf=lambda x: isinstance(x, RCM.P_))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init) for path, s in want}
    got = {path: (s.shape, s.init)
           for path, s in tree_leaves(build(C.get(arch)).specs)}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == PARAMS[arch]


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_full_cache_specs_match_reference(arch):
    """Decode-cache shapes and dtypes at batch 4 and 2,112 positions."""
    want = RT.init_cache_specs(RC.get(arch), 4, 2112)
    got = build(C.get(arch)).cache_specs(4, 2112)
    assert got.keys() == want.keys()
    for key, spec in want.items():
        assert got[key].shape == spec.shape, key
        assert str(got[key].dtype).replace("torch.", "") == \
            np.dtype(spec.dtype).name, key


# ---------------------------------------------------------------------------
# Attention at qwen3-4b's head shape
# ---------------------------------------------------------------------------

def test_apply_rope_matches_reference_at_theta_1e6():
    """Positions 0 to 4,095 at d = 128, theta = 1e6 (qwen3-4b)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4096, 2, 128)).astype(np.float32)
    pos = np.arange(4096, dtype=np.int32)[None]
    want = np.asarray(RCM.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.fixture(scope="module")
def attn_case():
    """qk-norm, 8 query heads over 2 KV heads (GQA group 4), d_head 128,
    rope theta 1e6, f32; positions run to 4,095."""
    jcfg = dataclasses.replace(RC.get_smoke("qwen3-4b"), n_heads=8,
                               n_kv_heads=2, d_head=128,
                               param_dtype=jnp.float32, act_dtype=jnp.float32)
    tcfg = dataclasses.replace(C.get_smoke("qwen3-4b"), n_heads=8,
                               n_kv_heads=2, d_head=128,
                               param_dtype=torch.float32,
                               act_dtype=torch.float32)
    assert jcfg.qk_norm and jcfg.rope_theta == 1e6
    specs = RA.attn_specs(jcfg, 1)
    jp = jax.tree_util.tree_map(
        lambda a: a[0], RCM.init_params(specs, jax.random.PRNGKey(3),
                                        jnp.float32))
    # qk-norm weights away from ones, so that they are seen
    rng = np.random.default_rng(7)
    for name in ("q_norm", "k_norm"):
        jp[name] = jnp.asarray(1 + 0.1 * rng.standard_normal(128), jnp.float32)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    pos = (4072 + np.arange(24, dtype=np.int32))[None].repeat(2, 0)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, tcfg, jp, tp, x, pos


@pytest.mark.parametrize("entry", ["attn_apply", "attn_prefill"])
def test_attention_matches_reference_qk_norm_gqa4_d128(attn_case, entry):
    jcfg, tcfg, jp, tp, x, pos = attn_case
    mesh = make_host_mesh()
    with use_mesh(mesh):
        want = getattr(RA, entry)(jnp.asarray(x), jp, jcfg, mesh,
                                  jnp.asarray(pos))
    with torch.no_grad():
        got = getattr(A, entry)(torch.from_numpy(x), tp, tcfg,
                                torch.from_numpy(pos))
    if entry == "attn_apply":
        want, got = (want,), (got,)
    else:
        want, got = (want[0], *want[1]), (got[0], *got[1])
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5
