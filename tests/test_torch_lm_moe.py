"""The port's moe family against the JAX reference, on the CPU.

``moe_apply`` on one layer's weights at capacities that drop assignments
and that drop none, without top-k renormalization and with the bf16 sum;
the kept-slot count of ``_route`` against the reference's routing rule on
the same logits; and the qwen3-moe and arctic (dense residual) smoke
stacks: the same parameters (drawn by the reference's ``init`` and
converted with ``lm_params_from_numpy``) and numpy tokens through the
reference's ``forward``, ``prefill`` and three ``decode_step`` calls and
through the port's.  At the published widths the configs and parameter
specs of both architectures are held against the reference's (nothing is
allocated).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.launch.mesh import make_host_mesh, use_mesh  # noqa: E402
from repro.models import common as RCM  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import build as rbuild  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import cache_to_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

PROMPT, DECODE = 40, 3
# The tolerances of tests/test_torch_lm_families.py: f32 is the same
# arithmetic in another order; in bf16 both sides round activations at
# different points.
TOL = {"f32": 1e-4, "bf16": 2e-2}
# moe_apply alone, f32: the expert products summed in another order.
TOL_MOE = 1e-5
ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
# Parameters of the published configs, counted from the reference's specs.
PARAMS = {"qwen3-moe-30b-a3b": 30_532_122_624,
          "arctic-480b": 476_850_275_328}


def _f32(jcfg, tcfg):
    return (dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                act_dtype=jnp.float32),
            dataclasses.replace(tcfg, param_dtype=torch.float32,
                                act_dtype=torch.float32))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# moe_apply and the routing rule, one layer
# ---------------------------------------------------------------------------

# case -> overrides of qwen3-moe's smoke config (8 experts, top 2)
MOE_CASES = {
    "drops": {"capacity_factor": 0.5},
    "no_drops": {"capacity_factor": 16.0},
    "no_norm_topk": {"capacity_factor": 0.5, "norm_topk": False},
    "bf16_sum": {"moe_psum_dtype": "bf16"},
    "expert_tp": {"moe_impl": "expert_tp"},
}


def _layer(overrides):
    jcfg, tcfg = _f32(RC.get_smoke("qwen3-moe-30b-a3b"),
                      C.get_smoke("qwen3-moe-30b-a3b"))
    jcfg = dataclasses.replace(jcfg, **overrides)
    tcfg = dataclasses.replace(tcfg, **overrides)
    jp = jax.tree_util.tree_map(lambda a: a[0], RCM.init_params(
        RM.moe_specs(jcfg, 1), jax.random.PRNGKey(2), jnp.float32))
    # router weights ten times the init scale, so that the top-k is
    # uneven and a low capacity drops assignments
    jp["router"] = jp["router"] * 10
    x = np.random.default_rng(3).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, tcfg, jp, tp, x


def _reference_keep(x, router, cfg, capacity):
    """The reference's routing rule (``repro.models.moe._moe_local`` on one
    shard, every expert local), as jnp: which assignments keep a slot."""
    logits = jnp.einsum("td,de->te", x.astype(jnp.float32),
                        router.astype(jnp.float32))
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat, cfg.n_experts + 1, dtype=jnp.int32)
    rank = jnp.cumsum(onehot, axis=0) - onehot
    myrank = jnp.take_along_axis(rank, flat[:, None], axis=1)[:, 0]
    return np.asarray(myrank < capacity)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    jcfg, tcfg, jp, tp, x = _layer(MOE_CASES[case])
    mesh = make_host_mesh()
    with use_mesh(mesh):
        want = np.asarray(RM.moe_apply(jnp.asarray(x), jp, jcfg, mesh))
    with torch.no_grad():
        got = M.moe_apply(torch.from_numpy(x), tp, tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL_MOE


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_route_keeps_the_reference_slots(case):
    """The kept slots of ``_route`` are the reference rule's, assignment by
    assignment; a capacity factor of 0.5 drops some, 16 drops none."""
    jcfg, tcfg, jp, tp, x = _layer(MOE_CASES[case])
    xf = x.reshape(-1, jcfg.d_model)
    capacity = M._capacity(xf.shape[0], tcfg)
    assert capacity == RM._capacity(xf.shape[0], jcfg, jcfg.n_experts)
    want = _reference_keep(jnp.asarray(xf), jp["router"], jcfg, capacity)
    r = M._route(torch.from_numpy(xf), tp["router"], tcfg, capacity)
    np.testing.assert_array_equal(r.keep.numpy(), want)
    assert int(r.keep.sum()) == int(want.sum())
    dropped = want.size - int(want.sum())
    if tcfg.capacity_factor < 1:
        assert dropped > 0
    if tcfg.capacity_factor >= tcfg.n_experts / tcfg.top_k:
        assert dropped == 0
    # a kept assignment owns its (expert, slot); dropped ones go to the
    # dump row E
    kept = torch.stack([r.slot_e[r.keep], r.slot_c[r.keep]], 1)
    assert len({tuple(s) for s in kept.tolist()}) == int(r.keep.sum())
    assert bool((r.slot_e[~r.keep] == tcfg.n_experts).all())
    assert int(r.slot_c.max()) < capacity


def test_capacity_is_the_reference_ceiling():
    for arch in ARCHS:
        jcfg, tcfg = RC.get(arch), C.get(arch)
        for t in (1, 4, 5, 1020, 1024, 8192):
            for cf in (0.5, 1.25, 16.0):
                assert M._capacity(t, dataclasses.replace(
                    tcfg, capacity_factor=cf)) == RM._capacity(
                    t, dataclasses.replace(jcfg, capacity_factor=cf),
                    jcfg.n_experts)


def test_unknown_moe_impl_raises():
    _, tcfg, _, tp, x = _layer({"moe_impl": "all_to_all"})
    with pytest.raises(ValueError, match="moe_impl"):
        M.moe_apply(torch.from_numpy(x), tp, tcfg)


# ---------------------------------------------------------------------------
# The smoke stacks: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module",
                params=[(a, p) for a in ARCHS for p in ("f32", "bf16")],
                ids=lambda ap: f"{ap[0]}-{ap[1]}")
def runs(request):
    """Reference and port outputs for one architecture and precision,
    computed once."""
    arch, precision = request.param
    jcfg, tcfg = RC.get_smoke(arch), C.get_smoke(arch)
    if precision == "f32":
        jcfg, tcfg = _f32(jcfg, tcfg)
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
        for t in range(DECODE):
            logits, cache = dec(jparams, cache,
                                tokens[:, PROMPT + t:PROMPT + t + 1])
            ref["decode"].append(np.asarray(logits, np.float32))

    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ttok = torch.from_numpy(tokens)
    port = {"decode": []}
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
    return precision, ref, port


def test_forward_logits_match_reference(runs):
    precision, ref, port = runs
    assert port["forward"].shape == ref["forward"].shape == (2, PROMPT, 256)
    assert _rel(port["forward"], ref["forward"]) <= TOL[precision]


def test_prefill_logits_match_reference(runs):
    precision, ref, port = runs
    assert port["prefill"].shape == (2, 256)
    assert _rel(port["prefill"], ref["prefill"]) <= TOL[precision]


@pytest.mark.parametrize("key", ("k", "v", "index"))
def test_prefill_cache_matches_reference(runs, key):
    precision, ref, port = runs
    assert port["cache"].keys() == ref["cache"].keys()
    got, want = port["cache"][key], ref["cache"][key]
    assert np.shape(got) == np.shape(want)
    if key == "index":
        assert int(got) == int(want) == PROMPT
    else:
        assert _rel(got, want) <= TOL[precision]


@pytest.mark.parametrize("step", range(DECODE))
def test_decode_logits_match_reference(runs, step):
    precision, ref, port = runs
    assert _rel(port["decode"][step], ref["decode"][step]) <= TOL[precision]


# ---------------------------------------------------------------------------
# Published widths: configs and specs (nothing allocated)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_full_lm_specs_match_reference(arch):
    """Keys, shapes and inits of every leaf, and the parameter count."""
    want = jax.tree_util.tree_flatten_with_path(
        RT.lm_specs(RC.get(arch)), is_leaf=lambda x: isinstance(x, RCM.P_))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init) for path, s in want}
    got = {path: (s.shape, s.init)
           for path, s in tree_leaves(build(C.get(arch)).specs)}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches_reference(arch):
    want, got = RC.get_smoke(arch), C.get_smoke(arch)
    assert (got.n_experts, got.top_k, got.d_expert_ff, got.n_layers,
            got.d_model, got.moe_dense_residual) == (
        want.n_experts, want.top_k, want.d_expert_ff, want.n_layers,
        want.d_model, want.moe_dense_residual) == (
        8, 2, 64, 2, 64, arch == "arctic-480b")
