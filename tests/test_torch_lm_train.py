"""The port's LM training path against the JAX reference, on the CPU.

For the smoke config of every architecture, in f32, the same parameters
(drawn by the reference's ``init`` and converted with
``lm_params_from_numpy``) and the same numpy batch go through the
reference's ``jax.value_and_grad(bundle.loss_fn)`` (one ``jax.jit`` per
architecture) and ``adamw_update`` (its ``train_step``) and through the
port's ``loss_fn``,
``value_and_grad`` and ``train_step``: the loss within 1e-5 relative, each
gradient leaf within 1e-4 relative (Frobenius), the new parameters within
1e-5 and the new moments within 1e-4.  Then ``microbatches=2`` (the vlm's
positions split on their axis 1) against the reference's scan and against
one batch; ``remat=True`` against ``remat=False`` in the port under both
policies (the reference's encdec cannot remat); ``cross_entropy`` on bf16
logits; ``cosine_schedule``; AdamW on a nested dict-and-list tree in f64;
and the kernel sites' routing in a differentiated step.
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
from repro.models.model import build as rbuild  # noqa: E402
from repro.optim import adamw as RAW  # noqa: E402
from repro.optim.adamw import OptConfig as ROptConfig  # noqa: E402
from repro.optim.schedule import cosine_schedule as rcosine  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, opt_state_from_numpy,
                                 opt_state_to_numpy)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models.common import cross_entropy, tree_leaves  # noqa: E402
from repro_torch.models.model import build, split_batch  # noqa: E402
from repro_torch.optim import adamw as TAW  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402

B, S = 2, 16
LOSS_TOL, GRAD_TOL, PARAM_TOL, MOMENT_TOL = 1e-5, 1e-4, 1e-5, 1e-4
# A small learning rate keeps the step's update well above the parameters'
# rounding, so the new-parameter check sees the update.
OPT = dict(lr=1e-2)
MICRO_ARCHS = ("qwen2-vl-72b",)
REMAT_ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "mamba2-2.7b", "zamba2-2.7b",
               "qwen2-vl-72b", "whisper-large-v3")


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _f32(cfg, lib):
    return dataclasses.replace(cfg, param_dtype=lib.float32,
                               act_dtype=lib.float32)


def _batch(cfg, seed=3, b=B):
    """tokens and labels (B, S), plus the vlm's (3, B, S) positions (three
    streams apart) and the encdec's frames, from a numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["positions"] = rng.integers(0, 64, (3, b, S)).astype(np.int32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _is_jax(tree):
    return not any(isinstance(t, torch.Tensor) for _, t in tree_leaves(tree))


def _np(tree):
    """A parameter-shaped tree (either package's) as {path: numpy array}."""
    if _is_jax(tree):
        return dict(tree_leaves(jax.tree_util.tree_map(np.asarray, tree)))
    return dict(tree_leaves(lm_params_to_numpy(tree)))


def _opt_state(jparams):
    """An AdamW state three steps in, drawn in numpy: first moments around
    1e-3, second moments in [1e-4, 2e-4].  (From zero moments the first
    step is about lr * sign(g), which turns the rounding of a gradient
    element near zero into a full step.)"""
    rng = np.random.default_rng(7)
    leaves = jax.tree_util.tree_map(np.asarray, jparams)
    return {"mu": jax.tree_util.tree_map(
                lambda p: 1e-3 * rng.standard_normal(p.shape).astype(np.float32),
                leaves),
            "nu": jax.tree_util.tree_map(
                lambda p: 1e-4 * (1 + rng.random(p.shape)).astype(np.float32),
                leaves),
            "count": np.int32(3)}


@pytest.fixture(scope="module", params=C.ARCHS)
def runs(request):
    """The reference's loss, gradients and train step for one architecture
    (one jit), and the port's, from the same parameters, moments and
    batch."""
    arch = request.param
    jcfg, tcfg = _f32(RC.get_smoke(arch), jnp), _f32(C.get_smoke(arch), torch)
    batch = _batch(jcfg)
    mesh = make_host_mesh()
    rb = rbuild(jcfg, mesh, opt_cfg=ROptConfig(**OPT))
    jparams = rb.init(jax.random.PRNGKey(0))
    opt_np = _opt_state(jparams)
    jopt = jax.tree_util.tree_map(jnp.asarray, opt_np)
    with use_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(rb.loss_fn))(jparams, batch)
    # the reference's train_step at microbatches=1: its value_and_grad, then
    # its adamw_update
    new_p, new_o, metrics = jax.jit(RAW.adamw_update, static_argnums=3)(
        grads, jopt, jparams, rb.opt_cfg)
    metrics["loss"] = loss
    ref = {"loss": float(loss), "grads": _np(grads), "params": _np(new_p),
           "mu": _np(new_o["mu"]), "nu": _np(new_o["nu"]),
           "grad_norm": float(metrics["grad_norm"]),
           "step_loss": float(metrics["loss"]), "count": int(new_o["count"])}

    bundle = build(tcfg, TAW.OptConfig(**OPT))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  device="cpu")
    tb = _torch_batch(batch)
    dispatch.reset_dispatch_stats()
    t_loss, t_grads = bundle.value_and_grad(params, tb)
    counters = dispatch.dispatch_stats()
    new_tp, new_to, t_metrics = bundle.train_step(
        params, opt_state_from_numpy(opt_np, device="cpu"), tb)
    port = {"loss": float(t_loss), "grads": _np(t_grads),
            "params": _np(new_tp), "mu": _np(new_to["mu"]),
            "nu": _np(new_to["nu"]), "grad_norm": float(t_metrics["grad_norm"]),
            "step_loss": float(t_metrics["loss"]),
            "count": int(new_to["count"]), "counters": counters,
            "forward_loss": float(bundle.loss_fn(params, tb))}
    return arch, ref, port


def test_loss_matches_reference(runs):
    _, ref, port = runs
    assert np.isfinite(port["loss"])
    assert abs(port["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    # the loss under no_grad is the differentiated one
    assert port["forward_loss"] == port["loss"]


def test_gradients_match_reference(runs):
    """Every gradient leaf, key for key."""
    _, ref, port = runs
    assert port["grads"].keys() == ref["grads"].keys()
    gaps = {"/".join(k): _rel(port["grads"][k], ref["grads"][k])
            for k in ref["grads"]}
    assert max(gaps.values()) <= GRAD_TOL, gaps


def test_train_step_matches_reference(runs):
    """One AdamW step over the nested tree, from the same moments (carried
    by ``opt_state_from_numpy``): new parameters at 1e-5, moments at 1e-4,
    the same grad norm, loss and count."""
    _, ref, port = runs
    for name, tol in (("params", PARAM_TOL), ("mu", MOMENT_TOL),
                      ("nu", MOMENT_TOL)):
        assert port[name].keys() == ref[name].keys()
        gaps = {"/".join(k): _rel(port[name][k], ref[name][k])
                for k in ref[name]}
        assert max(gaps.values()) <= tol, (name, max(gaps, key=gaps.get),
                                           max(gaps.values()))
    assert abs(port["grad_norm"] - ref["grad_norm"]) <= GRAD_TOL * ref["grad_norm"]
    assert port["step_loss"] == port["loss"]
    assert port["count"] == ref["count"] == 4


def test_differentiated_step_routes_dense(runs):
    """Under autograd every attention and SSD site call runs its plain
    version, counted as a differentiated call; no kernel is reached."""
    arch, _, port = runs
    counters = port["counters"]
    cfg = C.get_smoke(arch)
    site = "ssd" if cfg.family == "ssm" else "attention"
    assert counters[f"dense_{site}_grad_calls"] > 0, counters
    assert not any(v for k, v in counters.items() if k.startswith("kernel_")), \
        counters


@pytest.mark.parametrize("arch", MICRO_ARCHS)
def test_microbatches_match_reference_and_one_batch(arch):
    """``microbatches=2`` against the reference's scan (new parameters at
    1e-5, loss at 1e-5) and against the port's single batch (the mean of
    two equal halves' losses is the whole batch's)."""
    jcfg, tcfg = _f32(RC.get_smoke(arch), jnp), _f32(C.get_smoke(arch), torch)
    batch = _batch(jcfg, seed=4, b=4)
    mesh = make_host_mesh()
    rb = rbuild(jcfg, mesh, opt_cfg=ROptConfig(**OPT))
    jparams = rb.init(jax.random.PRNGKey(1))
    with use_mesh(mesh):
        new_p, _, metrics = jax.jit(
            lambda p, o, b: rb.train_step(p, o, b, microbatches=2))(
            jparams, RAW.adamw_init(jparams), batch)
    bundle = build(tcfg, TAW.OptConfig(**OPT))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  device="cpu")
    tb = _torch_batch(batch)
    got_p, _, got = bundle.train_step(params, TAW.adamw_init(params), tb,
                                      microbatches=2)
    assert abs(float(got["loss"]) - float(metrics["loss"])) <= \
        LOSS_TOL * abs(float(metrics["loss"]))
    want_p, ported = _np(new_p), _np(got_p)
    gaps = {"/".join(k): _rel(ported[k], want_p[k]) for k in want_p}
    assert max(gaps.values()) <= PARAM_TOL, gaps
    one_p, _, one = bundle.train_step(params, TAW.adamw_init(params), tb)
    assert abs(float(one["loss"]) - float(got["loss"])) <= \
        1e-6 * abs(float(one["loss"]))
    one_p = _np(one_p)
    assert max(_rel(ported[k], one_p[k]) for k in one_p) <= PARAM_TOL


def test_split_batch_cuts_vlm_positions_on_axis_1():
    batch = {"tokens": torch.arange(8).reshape(4, 2),
             "positions": torch.arange(24).reshape(3, 4, 2)}
    parts = split_batch(batch, 2)
    assert [p["tokens"].tolist() for p in parts] == [[[0, 1], [2, 3]],
                                                     [[4, 5], [6, 7]]]
    assert parts[1]["positions"].shape == (3, 2, 2)
    assert torch.equal(parts[1]["positions"], batch["positions"][:, 2:])
    with pytest.raises(ValueError, match="microbatches"):
        split_batch(batch, 3)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_leaves_loss_and_gradients(arch, policy):
    """One checkpoint per block: the loss bit for bit, the gradients within
    1e-6, the same number of differentiated site calls recomputed."""
    base = _f32(C.get_smoke(arch), torch)
    params = build(base).init(0, "cpu")
    tb = _torch_batch(_batch(base))
    results = {}
    for on in (False, True):
        cfg = dataclasses.replace(base, remat=on, remat_policy=policy)
        dispatch.reset_dispatch_stats()
        loss, grads = build(cfg).value_and_grad(params, tb)
        results[on] = (loss, _np(grads), dispatch.dispatch_stats())
    assert torch.equal(results[True][0], results[False][0])
    gaps = {k: _rel(results[True][1][k], results[False][1][k])
            for k in results[False][1]}
    assert max(gaps.values()) <= 1e-6, gaps
    site = "ssd" if base.family == "ssm" else "attention"
    calls = {on: r[2][f"dense_{site}_grad_calls"] for on, r in results.items()}
    if policy == "nothing":
        # each checkpointed block's sites run again in the recompute; the
        # hybrid family's shared attention block is not checkpointed
        want = calls[False] if base.family == "hybrid" else 2 * calls[False]
        assert calls[True] == want, calls


def test_remat_step_counts_two_dense_attention_calls_per_layer():
    """The chip's Qwen3-4B step in small: remat "nothing", every layer's
    attention runs dense in the forward and again in the recompute."""
    cfg = dataclasses.replace(_f32(C.get_smoke("qwen3-4b"), torch), remat=True)
    bundle = build(cfg)
    params = bundle.init(0, "cpu")
    dispatch.reset_dispatch_stats()
    bundle.train_step(params, TAW.adamw_init(params),
                      _torch_batch(_batch(cfg)), donate=True)
    stats = dispatch.dispatch_stats()
    assert stats["dense_attention_grad_calls"] == 2 * cfg.n_layers
    assert stats["kernel_attention_calls"] == 0


def test_validation_loss_through_the_kernel_site():
    """Under no_grad a forced kernel mode reaches the attention kernel's
    form once per layer (its plain version on a CPU tensor), and gives the
    dense loss."""
    cfg = dataclasses.replace(_f32(C.get_smoke("qwen3-4b"), torch), remat=True)
    bundle = build(cfg)
    params = bundle.init(0, "cpu")
    tb = _torch_batch(_batch(cfg))
    losses = {}
    for mode in ("kernel", "dense"):
        prev = dispatch.set_kernel_backend(mode)
        dispatch.reset_dispatch_stats()
        try:
            with torch.no_grad():
                losses[mode] = bundle.loss_fn(params, tb)
        finally:
            dispatch.set_kernel_backend(prev)
        stats = dispatch.dispatch_stats()
        assert stats[f"{mode}_attention_calls"] == cfg.n_layers, stats
    assert torch.equal(losses["kernel"], losses["dense"])


def test_cross_entropy_on_bf16_logits():
    rng = np.random.default_rng(6)
    logits = (4 * rng.standard_normal((2, 8, 300))).astype(np.float32)
    labels = rng.integers(0, 300, (2, 8)).astype(np.int32)
    lb = jnp.asarray(logits).astype(jnp.bfloat16)
    want = float(RCM.cross_entropy(lb, jnp.asarray(labels)))
    got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                        torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("step", [0, 50, 5050, 20000])
def test_cosine_schedule_matches_reference(step):
    """At 0, in the warmup, mid-decay and after ``total``."""
    kw = dict(peak_lr=3e-4, warmup=100, total=10000, min_frac=0.1)
    want = float(rcosine(step, **kw))
    got = cosine_schedule(step, **kw)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-7 * max(abs(want), 1e-30)


def test_adamw_nested_tree_matches_reference():
    """A nested dict-and-list tree in f64, three steps, at 1e-12; the
    reference's leaf order (dict keys sorted, lists in order) and the
    tree's structure kept."""
    rng = np.random.default_rng(8)

    def draw():
        return {"z": rng.standard_normal((3,)),
                "a": [rng.standard_normal((2, 2)),
                      {"k": rng.standard_normal((4,)),
                       "b": rng.standard_normal(())}]}

    def as_torch(node):     # keeps the dicts' own key order
        if isinstance(node, dict):
            return {k: as_torch(v) for k, v in node.items()}
        if isinstance(node, list):
            return [as_torch(v) for v in node]
        return torch.tensor(node)

    params = draw()
    cfg = dict(lr=0.05, weight_decay=0.01, grad_clip=0.5)
    tp = as_torch(params)
    ts = TAW.adamw_init(tp, torch.float64)
    with jax.enable_x64(True):
        rp = jax.tree_util.tree_map(jnp.asarray, params)
        rs = RAW.adamw_init(rp, jnp.float64)
        for _ in range(3):
            g = draw()
            tp, ts, tm = TAW.adamw_update(as_torch(g), ts, tp,
                                          TAW.OptConfig(**cfg))
            rp, rs, rm = RAW.adamw_update(jax.tree_util.tree_map(jnp.asarray, g),
                                          rs, rp, ROptConfig(**cfg))
        rp, rs, rm = jax.tree_util.tree_map(np.asarray, (rp, rs, rm))
    assert list(tp) == ["z", "a"] and isinstance(tp["a"], list)
    for got, want in ((tp, rp), (ts["mu"], rs["mu"]), (ts["nu"], rs["nu"])):
        got = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), got))
        want = jax.tree_util.tree_leaves(want)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.dtype == np.float64
            assert np.max(np.abs(a - np.asarray(b))) <= \
                1e-12 * max(np.max(np.abs(np.asarray(b))), 1e-30)
    assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
        1e-12 * float(rm["grad_norm"])


@pytest.mark.parametrize("slice_elements", [1 << 26, 4])
def test_adamw_donate_writes_the_same_values_in_place(slice_elements,
                                                      monkeypatch):
    """In place, whole or in slices of the leading axis, bit for bit the
    functional update."""
    monkeypatch.setattr(TAW, "DONATE_SLICE_ELEMENTS", slice_elements)
    rng = np.random.default_rng(2)
    params = {"w": torch.tensor(rng.standard_normal((3, 2)), dtype=torch.float32),
              "s": [torch.tensor(rng.standard_normal(4),
                                 dtype=torch.bfloat16)]}
    grads = {"w": torch.tensor(rng.standard_normal((3, 2)), dtype=torch.float32),
             "s": [torch.tensor(rng.standard_normal(4), dtype=torch.bfloat16)]}
    cfg = TAW.OptConfig(lr=0.1)
    want_p, want_s, _ = TAW.adamw_update(grads, TAW.adamw_init(params), params,
                                         cfg)
    state = TAW.adamw_init(params)
    w, mu = params["w"], state["mu"]["w"]
    got_p, got_s, _ = TAW.adamw_update(grads, state, params, cfg, donate=True)
    assert got_p is params and got_s is state
    assert got_p["w"] is w and got_s["mu"]["w"] is mu
    for a, b in zip(TAW._leaves(got_p) + TAW._leaves(got_s["nu"]),
                    TAW._leaves(want_p) + TAW._leaves(want_s["nu"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got_s["count"]) == 1


def test_abstract_state_matches_reference():
    """``abstract_params``/``abstract_opt_state`` on meta tensors: the
    reference's shapes and dtypes at the published Qwen3-4B widths, with
    nothing allocated."""
    arch = "qwen3-4b"
    rb = rbuild(RC.get(arch), make_host_mesh())
    bundle = build(C.get(arch))
    want = dict(tree_leaves(rb.abstract_params()))
    got = dict(tree_leaves(bundle.abstract_params()))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == w.shape
        assert str(got[k].dtype).replace("torch.", "") == np.dtype(w.dtype).name
    opt = bundle.abstract_opt_state()
    ropt = rb.abstract_opt_state()
    assert opt["count"].dtype == torch.int32 and opt["count"].shape == ()
    for k, w in dict(tree_leaves(ropt["mu"])).items():
        assert dict(tree_leaves(opt["mu"]))[k].dtype == torch.float32
        assert tuple(dict(tree_leaves(opt["nu"]))[k].shape) == w.shape


def test_opt_state_round_trips_through_numpy():
    cfg = _f32(C.get_smoke("smollm-360m"), torch)
    bundle = build(cfg)
    params = bundle.init(0, "cpu")
    tb = _torch_batch(_batch(cfg))
    _, state, _ = bundle.train_step(params, TAW.adamw_init(params), tb)
    back = opt_state_from_numpy(opt_state_to_numpy(state), device="cpu")
    assert int(back["count"]) == 1 and back["count"].dtype == torch.int32
    for a, b in zip(TAW._leaves(back["mu"]) + TAW._leaves(back["nu"]),
                    TAW._leaves(state["mu"]) + TAW._leaves(state["nu"])):
        assert torch.equal(a, b)
