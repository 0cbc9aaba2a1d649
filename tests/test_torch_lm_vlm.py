"""The port's vlm family (Qwen2-VL's M-RoPE decoder) against the JAX
reference, on the CPU.

``apply_mrope`` at Qwen2-VL's sections (16, 24, 24), d_head 128, on random
(3, B, S) positions; the qwen2-vl smoke stack (sections (2, 3, 3)) on the
reference's converted parameters, with random (3, B, S) positions whose
three streams differ, through ``forward``, ``prefill`` and three
``decode_step`` calls, and with stub embeddings in place of the tokens; the
text-only default positions; and, at the published widths, the config and
parameter specs (nothing is allocated).
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
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import build as rbuild  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import cache_to_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import apply_mrope, tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "qwen2-vl-72b"
PROMPT, DECODE = 40, 3
# The tolerances of tests/test_torch_lm_families.py.
TOL = {"f32": 1e-4, "bf16": 2e-2}
PARAMS = 72_705_384_448


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _positions(rng, b, s):
    """(3, B, S) positions, the three streams drawn apart."""
    return rng.integers(0, 4096, size=(3, b, s)).astype(np.int32)


def test_apply_mrope_matches_reference():
    """Qwen2-VL's sections at d_head 128, theta 1e6."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 4, 128)).astype(np.float32)
    pos = _positions(rng, 2, 64)
    want = np.asarray(RCM.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                      (16, 24, 24), 1e6))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                      (16, 24, 24), 1e6)
    assert _rel(got.numpy(), want) <= 1e-6


def test_apply_mrope_refuses_sections_off_half_the_head():
    x = torch.zeros(1, 2, 1, 128)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int32), (16, 24, 23))


def test_mrope_with_equal_streams_is_rope():
    """Text-only positions (the three streams equal) rotate as RoPE."""
    from repro_torch.models.common import apply_rope
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 16)).astype(np.int32))
    torch.testing.assert_close(
        apply_mrope(x, pos.expand(3, 2, 16), (2, 3, 3), 1e6),
        apply_rope(x, pos, 1e6), rtol=0, atol=0)


def test_default_positions_are_three_text_streams():
    cfg = C.get_smoke(ARCH)
    pos = T.default_positions(cfg, 2, 5)
    assert pos.shape == (3, 2, 5)
    assert bool((pos == torch.arange(5)).all())


@pytest.fixture(scope="module", params=["f32", "bf16"])
def runs(request):
    precision = request.param
    jcfg, tcfg = RC.get_smoke(ARCH), C.get_smoke(ARCH)
    assert tcfg.mrope_sections == jcfg.mrope_sections == (2, 3, 3)
    if precision == "f32":
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                   act_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.float32,
                                   act_dtype=torch.float32)
    jcache, tcache = ((jnp.float32, torch.float32) if precision == "f32"
                      else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab, size=(2, PROMPT + DECODE)
                          ).astype(np.int32)
    pos = _positions(rng, 2, PROMPT + DECODE)
    emb = (0.02 * rng.standard_normal((2, PROMPT, jcfg.d_model))
           ).astype(np.float32)
    mesh = make_host_mesh()
    jparams = rbuild(jcfg, mesh).init(jax.random.PRNGKey(0))
    ref = {"decode": []}
    with use_mesh(mesh):
        fwd = jax.jit(lambda p, t, q: RT.forward(p, jcfg, mesh, t, q))
        fwd_emb = jax.jit(lambda p, q, e: RT.forward(p, jcfg, mesh, None, q,
                                                     embeddings=e))
        pre = jax.jit(lambda p, t, q: RT.prefill(
            p, jcfg, mesh, t, PROMPT + DECODE, positions=q,
            cache_dtype=jcache))
        dec = jax.jit(lambda p, c, t, q: RT.decode_step(p, jcfg, mesh, c, t,
                                                        positions=q))
        ref["forward"] = np.asarray(fwd(jparams, tokens[:, :PROMPT],
                                        pos[..., :PROMPT]), np.float32)
        ref["embeddings"] = np.asarray(fwd_emb(jparams, pos[..., :PROMPT],
                                               emb), np.float32)
        logits, cache = pre(jparams, tokens[:, :PROMPT], pos[..., :PROMPT])
        ref["prefill"] = np.asarray(logits, np.float32)
        ref["cache"] = {k: np.asarray(v, np.float32) for k, v in cache.items()}
        for t in range(PROMPT, PROMPT + DECODE):
            logits, cache = dec(jparams, cache, tokens[:, t:t + 1],
                                pos[..., t:t + 1])
            ref["decode"].append(np.asarray(logits, np.float32))

    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ttok, tpos = torch.from_numpy(tokens), torch.from_numpy(pos)
    port = {"decode": []}
    with torch.no_grad():
        port["forward"] = T.forward(params, tcfg, ttok[:, :PROMPT],
                                    tpos[..., :PROMPT]).float()
        port["embeddings"] = T.forward(params, tcfg, None, tpos[..., :PROMPT],
                                       embeddings=torch.from_numpy(emb)
                                       ).float()
        logits, cache = T.prefill(params, tcfg, ttok[:, :PROMPT],
                                  PROMPT + DECODE, positions=tpos[..., :PROMPT],
                                  cache_dtype=tcache)
        port["prefill"] = logits.float()
        port["cache"] = cache_to_numpy(cache)
        for t in range(PROMPT, PROMPT + DECODE):
            logits, cache = T.decode_step(params, tcfg, cache,
                                          ttok[:, t:t + 1], tpos[..., t:t + 1])
            port["decode"].append(logits.float())
    return precision, ref, port


@pytest.mark.parametrize("entry", ["forward", "embeddings", "prefill"])
def test_logits_match_reference(runs, entry):
    precision, ref, port = runs
    assert port[entry].shape == ref[entry].shape
    assert _rel(port[entry], ref[entry]) <= TOL[precision]


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


def test_full_lm_specs_match_reference():
    """Keys, shapes and inits of every leaf, and the parameter count."""
    want = jax.tree_util.tree_flatten_with_path(
        RT.lm_specs(RC.get(ARCH)), is_leaf=lambda x: isinstance(x, RCM.P_))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init) for path, s in want}
    got = {path: (s.shape, s.init)
           for path, s in tree_leaves(build(C.get(ARCH)).specs)}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == PARAMS
