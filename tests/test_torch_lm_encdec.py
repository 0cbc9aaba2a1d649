"""The port's encdec family (the Whisper backbone) against the JAX
reference, on the CPU.

The same parameters (drawn by the reference's ``init`` and converted with
``lm_params_from_numpy``), numpy frame embeddings and tokens go through the
reference's ``encode``, ``cross_kv`` (filling each decoder layer's cross
K/V), ``decode_train`` and three ``decode_step`` calls and through the
port's, at the whisper smoke config (``remat=False``: the reference's
``encode``/``decode_train`` reach an undefined ``_ckpt_policy`` under
remat).  Then the bundle's encdec branches, and, at the published widths,
the config, parameter and cache specs (nothing is allocated).
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
from repro.models import encdec as RE  # noqa: E402
from repro.models.model import build as rbuild  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import cache_to_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models.common import take, tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "whisper-large-v3"
SEQ, DECODE = 12, 3
# The tolerances of tests/test_torch_lm_families.py.
TOL = {"f32": 1e-4, "bf16": 2e-2}
PARAMS = 2_062_364_160


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def runs(request):
    precision = request.param
    jcfg, tcfg = RC.get_smoke(ARCH), C.get_smoke(ARCH)
    assert not jcfg.remat and (jcfg.n_enc_layers, jcfg.enc_frames) == (2, 16)
    if precision == "f32":
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.float32,
                                   act_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.float32,
                                   act_dtype=torch.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if precision == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((2, jcfg.enc_frames, jcfg.d_model)
                                 ).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab, size=(2, SEQ)).astype(np.int32)
    mesh = make_host_mesh()
    jparams = rbuild(jcfg, mesh).init(jax.random.PRNGKey(0))
    ref = {"decode": []}
    with use_mesh(mesh):
        enc = jax.jit(lambda p, f: RE.encode(p, jcfg, mesh, f))
        dtrain = jax.jit(lambda p, t, m: RE.decode_train(p, jcfg, mesh, t, m))
        xkv = jax.jit(lambda m, lp: RA.cross_kv(m, lp, jcfg))
        dec = jax.jit(lambda p, c, t: RE.decode_step(p, jcfg, mesh, c, t))
        enc_out = enc(jparams, frames)
        ref["encode"] = np.asarray(enc_out, np.float32)
        ref["decode_train"] = np.asarray(dtrain(jparams, tokens, enc_out),
                                         np.float32)
        cache = {k: jnp.zeros(s.shape, s.dtype) for k, s in
                 RE.init_cache_specs(jcfg, 2, SEQ, dtype=jdt).items()}
        for i in range(jcfg.n_layers):
            lp = jax.tree_util.tree_map(lambda a: a[i],
                                        jparams["dec"]["xattn"])
            k, v = xkv(enc_out, lp)
            cache["xk"] = cache["xk"].at[i].set(k.astype(jdt))
            cache["xv"] = cache["xv"].at[i].set(v.astype(jdt))
        ref["cross"] = {k: np.asarray(cache[k], np.float32)
                        for k in ("xk", "xv")}
        for t in range(DECODE):
            logits, cache = dec(jparams, cache, tokens[:, t:t + 1])
            ref["decode"].append(np.asarray(logits, np.float32))
        ref["cache"] = {k: np.asarray(v, np.float32) for k, v in cache.items()}

    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ttok = torch.from_numpy(tokens)
    port = {"decode": []}
    bundle = build(tcfg)
    with torch.no_grad():
        enc_out = bundle.encode_step(params, torch.from_numpy(frames))
        port["encode"] = enc_out.float()
        port["decode_train"] = E.decode_train(params, tcfg, ttok,
                                              enc_out).float()
        cache = E.init_cache(tcfg, 2, SEQ, dtype=tdt, device="cpu")
        for i in range(tcfg.n_layers):
            k, v = A.cross_kv(enc_out, take(params["dec"]["xattn"], i), tcfg)
            cache["xk"][i], cache["xv"][i] = k, v
        port["cross"] = {k: cache[k].float() for k in ("xk", "xv")}
        for t in range(DECODE):
            logits, cache = bundle.serve_step(params, cache, ttok[:, t:t + 1])
            port["decode"].append(logits.float())
        port["cache"] = cache_to_numpy(cache)
    return precision, ref, port


@pytest.mark.parametrize("entry", ["encode", "decode_train"])
def test_full_sequence_matches_reference(runs, entry):
    precision, ref, port = runs
    assert port[entry].shape == ref[entry].shape
    assert _rel(port[entry], ref[entry]) <= TOL[precision]


@pytest.mark.parametrize("key", ["xk", "xv"])
def test_cross_kv_matches_reference(runs, key):
    precision, ref, port = runs
    assert port["cross"][key].shape == ref["cross"][key].shape
    assert _rel(port["cross"][key], ref["cross"][key]) <= TOL[precision]


@pytest.mark.parametrize("step", range(DECODE))
def test_decode_logits_match_reference(runs, step):
    precision, ref, port = runs
    assert _rel(port["decode"][step], ref["decode"][step]) <= TOL[precision]


@pytest.mark.parametrize("key", ["k", "v", "index"])
def test_decode_cache_matches_reference(runs, key):
    """The self-attention K/V written by three decode steps."""
    precision, ref, port = runs
    assert port["cache"].keys() == ref["cache"].keys()
    got, want = port["cache"][key], ref["cache"][key]
    assert np.shape(got) == np.shape(want)
    if key == "index":
        assert int(got) == int(want) == DECODE
    else:
        assert _rel(got[:, :, :DECODE], want[:, :, :DECODE]) <= TOL[precision]


def test_decode_steps_follow_decode_train(runs):
    """Each decode step's logits are the teacher-forced decoder's at that
    position (the port against itself)."""
    precision, _, port = runs
    for t in range(DECODE):
        assert _rel(port["decode"][t], port["decode_train"][:, t]) \
            <= TOL[precision]


def test_prefill_step_refuses_encdec():
    bundle = build(C.get_smoke(ARCH))
    with pytest.raises(ValueError, match="encode_step"):
        bundle.prefill_step({}, torch.zeros((1, 4), dtype=torch.int64))


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


def test_full_specs_match_reference():
    """Keys, shapes and inits of every leaf, and the parameter count."""
    want = jax.tree_util.tree_flatten_with_path(
        RE.encdec_specs(RC.get(ARCH)), is_leaf=lambda x: isinstance(x, RCM.P_))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init) for path, s in want}
    got = {path: (s.shape, s.init)
           for path, s in tree_leaves(build(C.get(ARCH)).specs)}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == PARAMS


def test_full_cache_specs_match_reference():
    """Batch 4 and Whisper's 448-token text context."""
    want = RE.init_cache_specs(RC.get(ARCH), 4, 448)
    got = build(C.get(ARCH)).cache_specs(4, 448)
    assert got.keys() == want.keys()
    for key, spec in want.items():
        assert got[key].shape == spec.shape, key
        assert str(got[key].dtype).replace("torch.", "") == \
            np.dtype(spec.dtype).name, key


def test_decoder_only_stack_refuses_encdec():
    from repro_torch.models import transformer as T
    with pytest.raises(ValueError, match="encdec"):
        T.lm_specs(C.get_smoke(ARCH))
