"""Kernel-dispatch semantics of the port, mirrored from tests/test_dispatch.py.

The hard dtype gate holds even when forced, per-site overrides and
``forced_dense`` restore, counters tick per decision, and
``backend_signature`` tracks every knob.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import planner  # noqa: E402
from repro_torch.core.orthogonalize import gram_qr, tall_project  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import zipup_block as ZB  # noqa: E402

SITES = ("gram", "tall_apply", "zipup_first_onelayer",
         "zipup_first_twolayer", "pair_merge")


@pytest.fixture(autouse=True)
def _restore_dispatch_state():
    prev_mode = dispatch.kernel_backend()
    prev_compute = dispatch.kernel_compute()
    yield
    dispatch.set_kernel_backend(prev_mode)   # also clears site overrides
    dispatch.set_kernel_compute(prev_compute)
    dispatch.reset_dispatch_stats()


def _randn(seed, *shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(shape)
    return torch.tensor(x, dtype=dtype)


def test_all_sites_registered_with_counters_in_planner_stats():
    regs = dispatch.registered_sites()
    st = planner.stats()
    for s in SITES:
        assert s in regs
        assert f"kernel_{s}_calls" in st and f"dense_{s}_calls" in st


def test_set_kernel_backend_returns_prev_and_validates():
    prev = dispatch.set_kernel_backend("dense")
    assert prev in ("auto", "kernel", "dense")
    assert dispatch.set_kernel_backend("auto") == "dense"
    with pytest.raises(ValueError, match="bad kernel backend"):
        dispatch.set_kernel_backend("pallas")
    with pytest.raises(KeyError, match="unknown kernel site"):
        dispatch.set_kernel_backend("kernel", site="nonexistent_site")
    with pytest.raises(KeyError):
        dispatch.dispatch("nonexistent_site")
    with pytest.raises(ValueError, match="unsupported kernel compute"):
        dispatch.set_kernel_compute("float16")


def test_forced_kernel_engages_eligible_dtype():
    a = _randn(0, 96, 13, 2)
    dispatch.set_kernel_backend("kernel")
    dispatch.reset_dispatch_stats()
    q, r = gram_qr(a, 1)
    s = dispatch.dispatch_stats()
    assert s["kernel_gram_calls"] == 1 and s["dense_gram_calls"] == 0
    assert s["kernel_tall_apply_calls"] == 1 and s["dense_tall_apply_calls"] == 0
    rec = torch.einsum("abk,kc->abc", q, r)
    np.testing.assert_allclose(rec.numpy(), a.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_forced_kernel_keeps_f64_c128_dense(dtype):
    """The dtype gate is HARD: f64/c128 never route to the f32 kernels."""
    a = _randn(1, 300, 8, dtype=dtype)
    dispatch.set_kernel_backend("kernel")
    dispatch.reset_dispatch_stats()
    gram_qr(a, 1)
    s = dispatch.dispatch_stats()
    assert s["kernel_gram_calls"] == 0 and s["dense_gram_calls"] == 1
    assert s["kernel_tall_apply_calls"] == 0 and s["dense_tall_apply_calls"] == 1


def test_auto_mode_is_dense_for_cpu_operands_even_tall_skinny():
    a = _randn(2, 8192, 16)
    dispatch.set_kernel_backend("auto")
    dispatch.reset_dispatch_stats()
    gram_qr(a, 1)
    s = dispatch.dispatch_stats()
    assert s["kernel_gram_calls"] == 0 and s["dense_gram_calls"] == 1
    # the shape gate itself engages only for CUDA operands
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dispatch.tall_skinny_auto(8192, 16, cuda)
    assert not dispatch.tall_skinny_auto(8192, 16, cpu)
    assert not dispatch.tall_skinny_auto(1024, 16, cuda)      # not big enough
    assert not dispatch.tall_skinny_auto(8192, 1024, cuda)    # small side too big


def test_forced_dense_mode_never_dispatches_kernel():
    a = _randn(3, 512, 24)
    dispatch.set_kernel_backend("dense")
    dispatch.reset_dispatch_stats()
    gram_qr(a, 1)
    s = dispatch.dispatch_stats()
    assert s["kernel_gram_calls"] == 0 and s["kernel_tall_apply_calls"] == 0
    assert s["dense_gram_calls"] == 1 and s["dense_tall_apply_calls"] == 1


def test_per_site_override_and_global_reset():
    a = _randn(4, 256, 12)
    dispatch.set_kernel_backend("dense")
    prev = dispatch.set_kernel_backend("kernel", site="gram")
    assert prev == "dense"
    assert dispatch.kernel_backend("gram") == "kernel"
    assert dispatch.kernel_backend("tall_apply") == "dense"
    dispatch.reset_dispatch_stats()
    gram_qr(a, 1)
    s = dispatch.dispatch_stats()
    assert s["kernel_gram_calls"] == 1
    assert s["dense_tall_apply_calls"] == 1
    dispatch.set_kernel_backend("auto")
    assert dispatch.kernel_backend("gram") == "auto"


def test_forced_dense_context_restores_mode_and_site_overrides():
    dispatch.set_kernel_backend("auto")
    dispatch.set_kernel_backend("kernel", site="tall_apply")
    a = _randn(5, 128, 6)
    with dispatch.forced_dense():
        assert dispatch.kernel_backend() == "dense"
        assert dispatch.kernel_backend("tall_apply") == "dense"
        dispatch.reset_dispatch_stats()
        gram_qr(a, 1)
        assert dispatch.dispatch_stats()["kernel_tall_apply_calls"] == 0
    assert dispatch.kernel_backend() == "auto"
    assert dispatch.kernel_backend("tall_apply") == "kernel"


def test_zipup_kernel_forms_match_dense():
    """Each zip-up site's kernel form reproduces its dense einsum."""
    s0 = _randn(6, 1, 5, 7)
    o0 = _randn(7, 5, 1, 3, 6)
    s0c = _randn(8, 1, 4, 4, 6, dtype=torch.complex64)
    tb0 = _randn(9, 2, 4, 1, 3, 5, dtype=torch.complex64)
    tk0 = torch.flip(tb0, dims=(1,))
    pm = (_randn(10, 2, 1, 3, 4, 5), _randn(11, 2, 1, 3, 4, 5))
    cases = [("zipup_first_onelayer", ZB.first_column_onelayer, (s0, o0)),
             ("zipup_first_twolayer", ZB.first_column_twolayer, (s0c, tb0, tk0)),
             ("pair_merge", ZB.pair_merge, pm)]
    for site, fn, args in cases:
        dispatch.set_kernel_backend("dense")
        want = fn(*args)
        dispatch.set_kernel_backend("kernel")
        dispatch.reset_dispatch_stats()
        got = fn(*args)
        assert dispatch.dispatch_stats()[f"kernel_{site}_calls"] == 1, site
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=site)


def test_zipup_kernels_hard_gate_c128():
    tb = _randn(12, 2, 1, 2, 2, 2, dtype=torch.complex128)
    dispatch.set_kernel_backend("kernel")
    dispatch.reset_dispatch_stats()
    ZB.pair_merge(tb.conj(), tb)
    s = dispatch.dispatch_stats()
    assert s["kernel_pair_merge_calls"] == 0 and s["dense_pair_merge_calls"] == 1


def test_tall_project_kernel_form_matches_tensordot():
    a = _randn(13, 17, 9, 11)
    mat = _randn(14, 99, 4)
    want = torch.tensordot(a, mat.reshape(9, 11, 4), dims=([1, 2], [0, 1]))
    dispatch.set_kernel_backend("kernel")
    got = tall_project(a, mat, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_backend_signature_tracks_every_knob():
    sigs = {dispatch.backend_signature()}
    dispatch.set_kernel_backend("kernel")
    sigs.add(dispatch.backend_signature())
    dispatch.set_kernel_backend("auto")
    dispatch.set_kernel_backend("kernel", site="gram")
    sigs.add(dispatch.backend_signature())
    dispatch.set_kernel_backend("auto")
    dispatch.set_kernel_compute("bfloat16")
    sigs.add(dispatch.backend_signature())
    dispatch.set_kernel_compute(None)
    assert len(sigs) == 4, "every knob must change the signature"
    assert dispatch.backend_signature() in sigs
    assert dispatch.backend_signature()[-1] == (
        "cuda" if torch.cuda.is_available() else "cpu")


def test_flipping_backend_is_a_new_fused_cache_key():
    from repro_torch.core import bmps as B
    from repro_torch.core.peps import random_onelayer
    gen = torch.Generator().manual_seed(6)
    rows = random_onelayer(3, 3, 2, gen, dtype=torch.complex64, device="cpu")
    opt = B.BMPS.randomized(4, niter=1, oversample=2)
    dispatch.set_kernel_backend("dense")
    v1 = B.contract_onelayer(rows, opt)
    before = planner.stats()
    B.contract_onelayer(rows, opt)
    assert planner.stats_since(before)["fused_misses"] == 0   # replay
    dispatch.set_kernel_backend("kernel")
    v2 = B.contract_onelayer(rows, opt)
    delta = planner.stats_since(before)
    assert delta["fused_misses"] > 0, "a backend flip must be a new cache key"
    assert delta["kernel_gram_calls"] > 0
    np.testing.assert_allclose(complex(v2), complex(v1), rtol=1e-4)
