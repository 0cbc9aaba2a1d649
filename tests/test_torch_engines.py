"""Boundary engines of the port: the registry, the variational engine, the
first-row pair merge and the orthogonalize aliases, c128 on the CPU.

The reference's own variational cases (``tests/test_engines.py``) run on
the port: full-chi exactness, beating zip-up at a truncating chi, planner
replay without misses, the instance option and environments that respect
the engine.  Against the reference on the same tensors (randomized solves
on ``JaxKey``s): variational one-layer contractions, norms, expectations
and a full-update gate on variational environments at 1e-10, and
``_init_twolayer_boundary``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import JaxKey, ref_to_port, rel_err, \
    rows_to_torch, to_numpy  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import expectation as RE  # noqa: E402
from repro.core import gates as RG  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core.engines.zipup import \
    _init_twolayer_boundary as r_init_twolayer  # noqa: E402
from repro.core.observable import Observable as RObs  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.core import orthogonalize as TO  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.engines import BoundaryEngine, get_engine, \
    registered_engines  # noqa: E402
from repro_torch.core.engines.variational import VariationalEngine  # noqa: E402
from repro_torch.core.engines.zipup import ZipUpEngine, \
    _init_twolayer_boundary  # noqa: E402
from repro_torch.core.environments import top_environments  # noqa: E402
from repro_torch.core.expectation import expectation  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import Observable as TObs  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

TOL = {"direct": 1e-12, "randomized": 1e-10}
PORT_TOL = 1e-10


def _rel(a, b):
    a, b = complex(a), complex(b)
    return abs(a - b) / max(abs(b), 1e-300)


def _onelayer(nrow, ncol, bond, seed):
    rows = RP.random_onelayer(nrow, ncol, bond, jax.random.PRNGKey(seed))
    return rows, rows_to_torch(rows)


def _state(nrow, ncol, bond, seed, scale=1.0):
    s = RP.random_peps(nrow, ncol, bond, jax.random.PRNGKey(seed))
    ref = RP.PEPS([[t * scale for t in row] for row in s.sites])
    return ref, ref_to_port(ref)


def _port_onelayer(nrow, ncol, bond, seed):
    gen = torch.Generator().manual_seed(seed)
    return TP.random_onelayer(nrow, ncol, bond, gen, device="cpu")


def _port_state(nrow, ncol, bond, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    s = TP.random_peps(nrow, ncol, bond, gen, device="cpu")
    return TP.PEPS([[t * scale for t in row] for row in s.sites])


def _exact_norm(state):
    return complex(TB.contract_exact_onelayer(
        TB.merge_layers(state.sites, state.sites)))


def _options(kind, chi, **kw):
    if kind == "direct":
        return RB.BMPS(chi, **kw), TB.BMPS(chi, **kw)
    return (RB.BMPS.randomized(chi, niter=2, oversample=4, fused=False, **kw),
            TB.BMPS.randomized(chi, niter=2, oversample=4, **kw))


# ------------------------------------------------------------ registry ----

def test_registry_and_resolution():
    engines = registered_engines()
    assert set(engines) >= {"zipup", "variational"}
    assert isinstance(get_engine("zipup"), ZipUpEngine)
    assert isinstance(get_engine("variational"), VariationalEngine)
    assert get_engine("zipup").supports_blocks
    assert not get_engine("variational").supports_blocks
    assert not BoundaryEngine.supports_blocks
    eng = VariationalEngine(sweeps=4)
    assert get_engine(eng) is eng and repr(eng) == "VariationalEngine(sweeps=4)"
    assert TB.BMPS(8, engine="variational").engine == "variational"
    assert TB.BMPS(8, engine=eng).engine is eng
    with pytest.raises(ValueError, match="sweeps"):
        VariationalEngine(sweeps=-1)


def test_unknown_engine_typeerror_lists_both_engines():
    with pytest.raises(TypeError, match=r"zipup.*variational|variational.*zipup"):
        get_engine("zip-up")
    with pytest.raises(TypeError, match="registered engines"):
        get_engine(42)
    with pytest.raises(TypeError, match=r"'variational', 'zipup'"):
        TB.BMPS(8, engine="nope")


# ----------------------------------------------- variational accuracy ----

@pytest.mark.parametrize("nrow,ncol,bond,chi,seed",
                         [(3, 3, 3, 27, 1), (4, 4, 2, 16, 2)])
def test_variational_exact_at_full_chi_onelayer(nrow, ncol, bond, chi, seed):
    rows = _port_onelayer(nrow, ncol, bond, seed)
    exact = complex(TB.contract_exact_onelayer(rows))
    v = TB.contract_onelayer(rows, TB.BMPS(chi, engine="variational"),
                             key=TorchKey(3))
    assert _rel(v, exact) <= 1e-8


def test_variational_exact_at_full_chi_twolayer():
    state = _port_state(3, 3, 2, seed=7)
    v = TB.norm_squared(state, TB.BMPS(40, engine="variational"),
                        key=TorchKey(17))
    assert _rel(v, _exact_norm(state)) <= 1e-8


def test_variational_beats_zipup_at_truncating_chi():
    rows = _port_onelayer(4, 4, 3, 42)
    exact = complex(TB.contract_exact_onelayer(rows))
    key = TorchKey(17)
    zip_err = _rel(TB.contract_onelayer(rows, TB.BMPS(8), key), exact)
    var_err = _rel(TB.contract_onelayer(
        rows, TB.BMPS(8, engine="variational"), key), exact)
    assert var_err < zip_err


def test_variational_cache_hit_rate():
    state = _port_state(4, 4, 2, seed=9, scale=2.0)
    opt = TB.BMPS.randomized(6, niter=2, oversample=4, engine="variational")
    TB.norm_squared(state, opt, key=TorchKey(17))          # warm-up
    before = planner.stats()
    TB.norm_squared(state, opt, key=TorchKey(17))          # replay
    delta = planner.stats_since(before)
    assert delta["path_misses"] == 0 and delta["fused_misses"] == 0
    assert delta["path_hits"] + delta["fused_hits"] > 50


def test_variational_engine_instance_option():
    rows = _port_onelayer(3, 3, 2, 4)
    exact = complex(TB.contract_exact_onelayer(rows))
    v = TB.contract_onelayer(rows, TB.BMPS(4, engine=VariationalEngine(3)),
                             key=TorchKey(17))
    assert _rel(v, exact) < 1.0
    # sweeps=0 is the zip-up seed itself
    v0 = TB.contract_onelayer(rows, TB.BMPS(4, engine=VariationalEngine(0)),
                              key=TorchKey(17))
    assert complex(v0) == complex(TB.contract_onelayer(rows, TB.BMPS(4),
                                                       key=TorchKey(17)))


def test_environments_respect_engine():
    state = _port_state(3, 3, 2, seed=7)
    envs = top_environments(state.sites, state.sites,
                            TB.BMPS(40, engine="variational"),
                            key=TorchKey(17))
    assert len(envs) == state.nrow + 1
    closed = get_engine("variational").final_scalar_twolayer(envs[-1])
    assert _rel(closed, _exact_norm(state)) <= 1e-8


# ------------------------------------------------ against the reference ----

@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_variational_contract_onelayer_matches_reference(kind):
    rows, trows = _onelayer(3, 3, 3, 42)
    ropt, topt = _options(kind, 3, engine="variational")
    want = RB.contract_onelayer(rows, ropt, key=jax.random.PRNGKey(17))
    got = TB.contract_onelayer(trows, topt, key=JaxKey(17))
    assert rel_err(to_numpy(got), want) <= PORT_TOL


@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_variational_norm_matches_reference(kind):
    # chi 4 is below the exact rank of every cut: at a larger chi the
    # boundary carries directions of zero weight, which the fit's QRs turn
    # into unit vectors that rounding alone picks, in each package its own
    ref, state = _state(2, 3, 2, seed=6, scale=2.0)
    ropt, topt = _options(kind, 4, engine="variational")
    want = RB.norm_squared(ref, ropt, key=jax.random.PRNGKey(5))
    got = TB.norm_squared(state, topt, key=JaxKey(5))
    assert rel_err(to_numpy(got), want) <= PORT_TOL


def test_variational_expectation_matches_reference():
    ref, state = _state(3, 3, 2, seed=11)
    ropt, topt = _options("randomized", 4, engine="variational")
    robs = RObs.Z(0) + RObs.XX(3, 4) + RObs.ZZ(1, 4)
    tobs = TObs.Z(0) + TObs.XX(3, 4) + TObs.ZZ(1, 4)
    want = complex(RE.expectation(ref, robs, ropt,
                                  key=jax.random.PRNGKey(2)))
    got = complex(expectation(state, tobs, topt, key=JaxKey(2)))
    assert _rel(got, want) <= PORT_TOL
    # and it is the variational engine that ran: zip-up reads otherwise
    zipup = complex(expectation(state, tobs, TB.BMPS.randomized(
        4, niter=2, oversample=4), key=JaxKey(2)))
    assert zipup != got


def test_full_update_on_variational_environments_matches_reference():
    """One full-update gate whose environment sweeps run the variational
    engine (``env_contract``): the same state as the reference's."""
    ref, state = _state(2, 3, 2, seed=0)
    g = RG.trotter_gate(-1.0 * RG.pauli_term("ZZ") + 0.3 * RG.pauli_term("XY"),
                        0.2)
    want = RP.apply_operator(ref, g, [0, 1], RP.FullUpdate(
        rank=2, env_contract=RB.BMPS(8, engine="variational")),
        key=jax.random.PRNGKey(4))
    got = TP.apply_operator(state, g, [0, 1], TP.FullUpdate(
        rank=2, env_contract=TB.BMPS(8, engine="variational")),
        key=JaxKey(4))
    assert rel_err(to_numpy(TP.to_statevector(got)),
                   RP.to_statevector(want)) <= PORT_TOL


def test_mixed_policy_demotes_the_fit_and_promotes_the_result(monkeypatch):
    """Under the mixed policy the ALS sweeps see the site tensors and the
    seed one tier down (c64) and the fitted boundary comes back in c128;
    the exact policy passes c128 through."""
    rows = _port_onelayer(3, 3, 2, 4)
    seen = []
    real_fit = VariationalEngine._fit

    def spy(self, sites, seed):
        seen.append(({t.dtype for site in sites for t in site},
                     {t.dtype for t in seed}))
        out = real_fit(self, sites, seed)
        seen[-1] += ({t.dtype for t in out},)
        return out

    monkeypatch.setattr(VariationalEngine, "_fit", spy)
    exact = TB.contract_onelayer(rows, TB.BMPS(8, engine="variational"),
                                 key=TorchKey(3))
    assert seen and all(s == ({torch.complex128},) * 3 for s in seen)
    seen.clear()
    mixed = TB.contract_onelayer(
        rows, TB.BMPS(8, engine="variational", precision="mixed"),
        key=TorchKey(3))
    assert seen and all(s == ({torch.complex64},) * 3 for s in seen)
    assert mixed.dtype == torch.complex128
    assert 0 < _rel(mixed, exact) <= 1e-5


# ------------------------------------------------------ the pair merge ----

def test_init_twolayer_boundary_matches_reference():
    ref, state = _state(2, 3, 2, seed=3)
    bra_ref, bra = _state(2, 3, 2, seed=4)
    want = r_init_twolayer(bra_ref.sites[0], ref.sites[0])
    got = _init_twolayer_boundary(bra.sites[0], state.sites[0])
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    for g, w in zip(got, want):
        assert rel_err(to_numpy(g), w) <= TOL["direct"]


def test_init_twolayer_boundary_kernel_form_against_dense(monkeypatch):
    """Forced kernel mode routes every column through the ``pair_merge``
    site's kernel form (its plain version on a CPU tensor), c64 against the
    dense route."""
    _, state = _state(2, 3, 2, seed=3)
    row = [t.to(torch.complex64) for t in state.sites[0]]
    calls = []
    site = dispatch.site("pair_merge")

    def kernel(tb, tk):
        calls.append((tuple(tb.shape), tb.is_conj()))
        return site.kernel_fn(tb, tk)

    monkeypatch.setitem(dispatch._SITES, "pair_merge",
                        dataclasses.replace(site, kernel_fn=kernel))
    with dispatch.forced_dense():
        want = _init_twolayer_boundary(row, row)
    assert calls == []
    prev = dispatch.set_kernel_backend("kernel")
    try:
        got = _init_twolayer_boundary(row, row)
    finally:
        dispatch.set_kernel_backend(prev)
    assert len(calls) == len(row) and all(conj for _, conj in calls)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.complex64
        assert rel_err(to_numpy(g), to_numpy(w)) <= 1e-6


# --------------------------------------------- orthogonalize aliases ----

def test_gram_backend_aliases():
    prev = TO.set_gram_backend("pallas")
    try:
        assert TO.gram_backend() == "kernel" == dispatch.kernel_backend()
        assert TO.set_gram_backend("dense") == "kernel"
        assert TO.gram_backend() == "dense"
        TO.set_gram_backend("auto")
        with pytest.raises(ValueError, match="bad gram backend"):
            TO.set_gram_backend("cuda")
        assert TO.gram_backend() == "auto"
    finally:
        dispatch.set_kernel_backend(prev)
    a = torch.randn(64, 4, dtype=torch.complex128)
    TO.reset_gram_dispatch_stats()
    TO.gram_qr(a, 1)
    stats = TO.gram_dispatch_stats()
    assert stats == dispatch.dispatch_stats()
    assert stats["dense_gram_calls"] == 1
    TO.reset_gram_dispatch_stats()
    assert all(v == 0 for v in TO.gram_dispatch_stats().values())
