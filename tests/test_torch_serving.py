"""Batched amplitudes and PEPS query serving of the port, c128 on the CPU.

Against the reference (the same numpy-built tensors through both packages,
randomized solves on ``JaxKey``s): ``final_row_amplitudes``,
``bmps.amplitudes`` and the one-layer prefix environments at 1e-12 with
``DirectSVD`` and 1e-10 with ``RandomizedSVD``; the port's
``ServingEngine`` against the reference's engine on the same state and
keys.  Then the port against itself, the cases of
``tests/test_serving.py``: served equals per-query, threaded clients lose,
duplicate and cross-wire nothing, the cache lifecycle, and the bucketing
and lifecycle infrastructure; and the ``launch.serve`` CLI on the CPU.
"""
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from test_torch_helpers import CPU, JaxKey, ref_to_port, rel_err, \
    to_numpy  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core.environments import \
    onelayer_prefix_environment as r_prefix_env  # noqa: E402
from repro.core.environments import \
    onelayer_top_environments as r_top_envs  # noqa: E402
from repro.core.observable import Observable as RObs  # noqa: E402
from repro.core.serving import ServingEngine as RServingEngine  # noqa: E402
from repro_torch.core import bmps as B  # noqa: E402
from repro_torch.core import peps as P  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD  # noqa: E402
from repro_torch.core.environments import onelayer_prefix_environment, \
    onelayer_top_environments  # noqa: E402
from repro_torch.core.expectation import expectation  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import Observable  # noqa: E402
from repro_torch.core.serving import DEFAULT_BUCKETS, LRUCache, \
    ServingEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

OPT = B.BMPS(8, DirectSVD())
TOL = {"direct": 1e-12, "randomized": 1e-10}


def _ref_state(seed, nrow=3, ncol=3):
    return RP.random_peps(nrow, ncol, 2, jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def ref33():
    return _ref_state(7)


@pytest.fixture(scope="module")
def state33(ref33):
    return ref_to_port(ref33)


@pytest.fixture(scope="module")
def state33b():
    return ref_to_port(_ref_state(8))


@pytest.fixture(scope="module")
def state23():
    return ref_to_port(_ref_state(9, 2, 3))


def _port_state(nrow, ncol, seed):
    gen = torch.Generator().manual_seed(seed)
    return P.random_peps(nrow, ncol, 2, gen, device=CPU)


def _bits(state, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (n, state.nrow, state.ncol))


def _direct(state, bits_batch, option=OPT):
    return np.array([complex(B.amplitude(state, b, option))
                     for b in bits_batch])


def _assert_close(served, direct, tol=1e-10):
    served = to_numpy(served) if torch.is_tensor(served) else np.asarray(served)
    scale = max(1.0, float(np.abs(direct).max()))
    assert np.abs(served - direct).max() <= tol * scale


def _same_mps(port_env, ref_env, tol):
    """Tensor by tensor with DirectSVD (whose gauge both packages fix the
    same way); through the gauge-invariant <env|env> otherwise."""
    def overlap(env):
        acc = np.ones((1, 1))
        for t in env:
            t = np.asarray(t)
            acc = np.einsum("ab,adc,bde->ce", acc, t.conj(), t)
        return acc.reshape(())
    if tol == TOL["direct"]:
        for t, r in zip(port_env, ref_env):
            assert rel_err(to_numpy(t), r) <= tol
    assert rel_err(overlap([to_numpy(t) for t in port_env]),
                   overlap(ref_env)) <= tol


def _options(kind, chi=4):
    """(reference option, port option, reference key, port key)."""
    if kind == "direct":
        return (RB.BMPS(chi), B.BMPS(chi), jax.random.PRNGKey(3), JaxKey(3))
    return (RB.BMPS.randomized(chi, niter=2, oversample=4, fused=False),
            B.BMPS.randomized(chi, niter=2, oversample=4),
            jax.random.PRNGKey(3), JaxKey(3))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_final_row_amplitudes_matches_reference(ref33, state33, kind):
    ropt, topt, rkey, tkey = _options(kind)
    bits = _bits(state33, 5, seed=1)
    prefix = bits[0, :-1]
    renv = r_prefix_env(ref33, prefix, ropt, rkey)
    tenv = onelayer_prefix_environment(state33, prefix, topt, tkey)
    _same_mps(tenv, renv, TOL[kind])
    want = RB.final_row_amplitudes(renv, ref33.sites[-1], bits[:, -1],
                                   ref33.log_scale)
    got = B.final_row_amplitudes(tenv, state33.sites[-1], bits[:, -1],
                                 state33.log_scale)
    assert got.shape == (5,) and got.dtype == torch.complex128
    assert rel_err(to_numpy(got), want) <= TOL[kind]


@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_bmps_amplitudes_matches_reference(ref33, state33, kind):
    ropt, topt, rkey, tkey = _options(kind)
    bits = _bits(state33, 7, seed=2)        # several distinct prefixes
    bits[3:5, :-1] = bits[0, :-1]
    want = RB.amplitudes(ref33, bits, ropt, rkey)
    got = B.amplitudes(state33, bits.reshape(7, -1), topt, tkey)
    assert rel_err(to_numpy(got), want) <= TOL[kind]


@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_prefix_environments_close_to_reference_amplitude(ref33, state33,
                                                         kind):
    """Closing the port's prefix environment repeats the reference's
    per-query contraction; the levels of ``onelayer_top_environments``
    equal the reference's (see ``_same_mps``)."""
    ropt, topt, rkey, tkey = _options(kind)
    bits = _bits(state33, 4, seed=3)
    bits[:, :-1] = bits[0, :-1]
    env = onelayer_prefix_environment(state33, bits[0, :-1], topt, tkey)
    got = B.final_row_amplitudes(env, state33.sites[-1], bits[:, -1],
                                 state33.log_scale)
    want = np.array([complex(RB.amplitude(ref33, b, ropt, rkey)) for b in bits])
    assert rel_err(to_numpy(got), want) <= TOL[kind]
    rows = [[t[int(bits[0, i, j])] for j, t in enumerate(row)]
            for i, row in enumerate(ref33.sites)]
    ref_levels = r_top_envs(rows, ropt, rkey)
    port_levels = onelayer_top_environments(
        [[t[int(bits[0, i, j])] for j, t in enumerate(row)]
         for i, row in enumerate(state33.sites)], topt, tkey)
    assert len(port_levels) == len(ref_levels) == 3
    for rl, tl in zip(ref_levels, port_levels):
        _same_mps(tl, rl, TOL[kind])


@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_serving_engine_matches_reference_engine(ref33, state33, kind):
    ropt, topt, _, _ = _options(kind)
    bits = _bits(state33, 9, seed=4)
    obs_r = RObs.Z(0) + RObs.XX(0, 1) + RObs.ZZ(1, 4)
    obs_t = Observable.Z(0) + Observable.XX(0, 1) + Observable.ZZ(1, 4)
    with RServingEngine(start=False) as reng, \
            ServingEngine(start=False) as teng:
        reng.register_state("s", ref33, ropt, key=jax.random.PRNGKey(3),
                            env_key=jax.random.PRNGKey(4))
        teng.register_state("s", state33, topt, key=JaxKey(3),
                            env_key=JaxKey(4))
        want = reng.amplitude_batch("s", bits)
        got = teng.amplitude_batch("s", bits)
        assert rel_err(to_numpy(got), want) <= TOL[kind]
        e_want = complex(reng.expectation("s", obs_r))
        e_got = complex(teng.expectation("s", obs_t))
        assert abs(e_got - e_want) <= TOL[kind] * abs(e_want)
        rst, tst = reng.stats(), teng.stats()
        assert {k: v for k, v in tst.items() if k != "per_state"} == \
            {k: v for k, v in rst.items() if k != "per_state"}
        assert tst["per_state"] == rst["per_state"]


# ---------------------------------------------------------------------------
# Equivalence: served == per-query bmps.amplitude
# ---------------------------------------------------------------------------

def test_final_row_amplitudes_matches_per_query(state33):
    bits = _bits(state33, 6, seed=1)
    bits[:, :-1] = bits[0, :-1]  # shared prefix
    env = onelayer_prefix_environment(state33, bits[0, :-1], OPT)
    out = B.final_row_amplitudes(env, state33.sites[-1], bits[:, -1, :],
                                 state33.log_scale)
    _assert_close(out, _direct(state33, bits))


@pytest.mark.parametrize("width", [B.CLOSE_WIDTH, 4])
def test_final_row_amplitudes_closes_at_one_width(state33, monkeypatch,
                                                  width):
    """The close runs in tiles of ``CLOSE_WIDTH`` (the last one padded):
    the values are the one-tile ones, and each query's value does not
    depend on the batch it came in or its place there."""
    bits = _bits(state33, 7, seed=9)
    bits[:, :-1] = bits[0, :-1]
    env = onelayer_prefix_environment(state33, bits[0, :-1], OPT)
    sites = state33.sites[-1]
    monkeypatch.setattr(B, "CLOSE_WIDTH", 7)
    whole = B.final_row_amplitudes(env, sites, bits[:, -1])
    monkeypatch.setattr(B, "CLOSE_WIDTH", width)
    tiled = B.final_row_amplitudes(env, sites, bits[:, -1])
    assert tiled.shape == (7,)
    _assert_close(tiled, to_numpy(whole), tol=1e-14)
    alone = [B.final_row_amplitudes(env, sites, bits[i:i + 1, -1])[0]
             for i in range(7)]
    assert all(bool(a == t) for a, t in zip(alone, tiled))
    reordered = B.final_row_amplitudes(env, sites, bits[::-1, -1])
    assert torch.equal(reordered.flip(0), tiled)
    with pytest.raises(ValueError, match=r"\(B, ncol\)"):
        B.final_row_amplitudes(env, sites, bits[0, -1])
    assert B.final_row_amplitudes(env, sites, bits[:0, -1]).shape == (0,)


def test_final_row_amplitudes_needs_a_bottom_row(state33):
    env = onelayer_prefix_environment(state33, [[0, 0, 0]], OPT)
    with pytest.raises(ValueError, match="bottom row"):
        B.final_row_amplitudes(env, state33.sites[1], np.zeros((1, 3), int))


def test_bmps_amplitudes_mixed_prefixes(state33):
    bits = _bits(state33, 7, seed=2)
    _assert_close(B.amplitudes(state33, bits, OPT), _direct(state33, bits))


def test_served_batch_matches_per_query(state33):
    with ServingEngine(start=False) as eng:
        eng.register_state("a", state33, OPT)
        bits = _bits(state33, 9, seed=3)
        _assert_close(eng.amplitude_batch("a", bits), _direct(state33, bits))


@settings(max_examples=6, deadline=None)
@given(nrow=st.integers(2, 3), ncol=st.integers(2, 3),
       chi=st.sampled_from([2, 4, 8]), seed=st.integers(0, 10**6))
def test_property_served_equals_per_query(nrow, ncol, chi, seed):
    state = _port_state(nrow, ncol, seed % 97)
    option = B.BMPS(chi, DirectSVD())
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (rng.integers(1, 6), nrow, ncol))
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state, option)
        _assert_close(eng.amplitude_batch("s", bits),
                      _direct(state, bits, option))


@pytest.mark.parametrize("engine", ["zipup", "variational"])
def test_served_both_engines(state33, engine):
    option = B.BMPS(4, DirectSVD(), engine=engine)
    bits = _bits(state33, 5, seed=4)
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, option)
        _assert_close(eng.amplitude_batch("s", bits),
                      _direct(state33, bits, option))


def test_served_randomized_svd(state33):
    option = B.BMPS(4, RandomizedSVD(niter=4, oversample=8))
    bits = _bits(state33, 5, seed=5)
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, option)
        _assert_close(eng.amplitude_batch("s", bits),
                      _direct(state33, bits, option))


@pytest.mark.parametrize("n", [1, 5, 150])
def test_served_ragged_batch_sizes(state33, n):
    # 1 (smallest bucket), 5 (not a bucket multiple), 150 (> largest bucket)
    with ServingEngine(start=False) as eng:
        eng.register_state("a", state33, OPT)
        bits = _bits(state33, n, seed=n)
        bits[:, :-1] = bits[0, :-1]  # one group, so chunking is exercised
        _assert_close(eng.amplitude_batch("a", bits), _direct(state33, bits))


def test_served_single_query_layouts(state33):
    with ServingEngine(start=False) as eng:
        eng.register_state("a", state33, OPT)
        bits = _bits(state33, 1, seed=6)[0]
        want = complex(B.amplitude(state33, bits, OPT))
        got_grid = complex(eng.amplitude("a", bits))
        got_flat = complex(eng.amplitude("a", bits.reshape(-1)))
        assert got_grid == got_flat
        _assert_close(np.array([got_grid]), np.array([want]))


def test_served_one_row_state():
    state = _port_state(1, 4, 12)
    bits = _bits(state, 4, seed=7)
    with ServingEngine(start=False) as eng:
        eng.register_state("row", state, OPT)
        _assert_close(eng.amplitude_batch("row", bits), _direct(state, bits))
    env = onelayer_prefix_environment(state, [], OPT)
    assert [tuple(t.shape) for t in env] == [(1, 1, 1)] * 4
    assert all(t.dtype == state.dtype and t.device == state.device
               for t in env)


def test_served_respects_log_scale(state33):
    scaled = P.PEPS([[t for t in row] for row in state33.sites],
                    log_scale=0.7)
    bits = _bits(state33, 3, seed=8)
    with ServingEngine(start=False) as eng:
        eng.register_state("s", scaled, OPT)
        _assert_close(eng.amplitude_batch("s", bits), _direct(scaled, bits))


def test_served_expectation_matches_direct(state33):
    obs = Observable.Z(0) + Observable.XX(0, 1) + Observable.ZZ(1, 4)
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, OPT)
        got = complex(eng.expectation("s", obs))
        want = complex(expectation(state33, obs, OPT))
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want))


def test_served_expectation_custom_env_key(state33):
    obs = Observable.Z(4)
    option = B.BMPS(4, RandomizedSVD(niter=2, oversample=4))
    key = TorchKey(33)
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, option, env_key=key)
        got = complex(eng.expectation("s", obs))
        want = complex(expectation(state33, obs, option, key=key))
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want))


def test_register_rejects_non_bmps_option(state33):
    with ServingEngine(start=False) as eng:
        with pytest.raises(TypeError, match="BMPS"):
            eng.register_state("d", state33, "not-an-option")
        with pytest.raises(TypeError, match="BMPS"):
            eng.register_state("d", state33, object())


def test_bmps_amplitudes_rejects_non_bmps(state33):
    with pytest.raises(TypeError, match="unknown contraction option"):
        B.amplitudes(state33, _bits(state33, 2), object())


# ---------------------------------------------------------------------------
# Concurrency: threaded clients, >= 2 states
# ---------------------------------------------------------------------------

def test_threaded_no_lost_dup_or_crosswired(state33, state33b):
    with ServingEngine(window_ms=5.0) as eng:
        eng.register_state("a", state33, OPT)
        eng.register_state("b", state33b, OPT)
        states = {"a": state33, "b": state33b}
        results = []
        res_lock = threading.Lock()

        def client(cid):
            rng = np.random.default_rng(100 + cid)
            futs = []
            for _ in range(8):
                name = ("a", "b")[rng.integers(2)]
                bits = rng.integers(0, 2, (3, 3))
                futs.append((name, bits, eng.submit_amplitude(name, bits)))
            for name, bits, fut in futs:
                v = fut.result(timeout=120)
                with res_lock:
                    results.append((cid, name, bits, v))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)

        assert len(results) == 32
        for cid, name, bits, v in results:
            assert torch.is_tensor(v) and v.device == state33.device
            want = complex(B.amplitude(states[name], bits, OPT))
            assert abs(complex(v) - want) <= 1e-10 * max(1.0, abs(want)), \
                f"cross-wired or corrupted response for client {cid}"
        assert eng.stats()["queries_amplitude"] == 32


def test_threaded_arrival_order_independence(state33):
    """Each value equals a synchronous batch of the same bits, whatever
    the dispatch cycles it was batched in."""
    bits = _bits(state33, 8, seed=11)
    with ServingEngine(window_ms=5.0) as eng:
        eng.register_state("a", state33, OPT)
        futs = [eng.submit_amplitude("a", b) for b in bits]
        first = [complex(f.result(timeout=120)) for f in futs]
        futs = [eng.submit_amplitude("a", b) for b in reversed(bits)]
        second = [complex(f.result(timeout=120)) for f in reversed(futs)]
        assert first == second
        single = [complex(eng.submit_amplitude("a", b).result(timeout=120))
                  for b in bits]
        sync = [complex(v) for v in eng.amplitude_batch("a", bits)]
        assert first == single == sync


def test_threaded_stress_more_clients_than_cores(state33):
    """More client threads than cores, a short switch interval, and
    synchronous calls racing the dispatcher: no query is lost, counted
    twice or answered with other bits than a synchronous batch gives."""
    n = (os.cpu_count() or 1) + 1
    bits = _bits(state33, 4, seed=23)
    bits[:, :-1] = bits[0, :-1]
    results, lock = [], threading.Lock()
    with ServingEngine(window_ms=1.0) as eng:
        eng.register_state("a", state33, OPT)
        want = [complex(v) for v in eng.amplitude_batch("a", bits)]

        def client(i):
            futs = [(k, eng.submit_amplitude("a", bits[k]))
                    for k in ((i + j) % 4 for j in range(3))]
            sync = complex(eng.amplitude("a", bits[i % 4]))
            got = [(k, complex(f.result(timeout=120))) for k, f in futs]
            with lock:
                results.extend(got + [(i % 4, sync)])

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 4 * n
        assert all(v == want[k] for k, v in results)
        assert eng.stats()["queries_amplitude"] == 4 + 4 * n


def test_threaded_mixed_kinds(state33, state33b):
    obs = Observable.Z(0)
    with ServingEngine(window_ms=5.0) as eng:
        eng.register_state("a", state33, OPT)
        eng.register_state("b", state33b, OPT)
        bits = _bits(state33, 4, seed=12)
        amp_futs = [eng.submit_amplitude("a", b) for b in bits]
        exp_futs = [eng.submit_expectation(n, obs) for n in ("a", "b")]
        _assert_close(np.array([complex(f.result(120)) for f in amp_futs]),
                      _direct(state33, bits))
        for fut, state in zip(exp_futs, (state33, state33b)):
            want = complex(expectation(state, obs, OPT))
            assert abs(complex(fut.result(120)) - want) <= \
                1e-12 * max(1.0, abs(want))


def test_stats_reconcile_with_query_log(state33):
    with ServingEngine(start=False) as eng:
        eng.register_state("a", state33, OPT)
        bits = _bits(state33, 4, seed=13)
        bits[:2, :-1] = bits[0, :-1]  # exactly 3 distinct prefixes
        bits[2:, :-1] = bits[2, :-1]
        prefixes = {b[:-1].tobytes() for b in bits}
        eng.amplitude_batch("a", bits)
        eng.amplitude_batch("a", bits)  # identical second round: all hits
        st_ = eng.stats()
        ps = st_["per_state"]["a"]
        assert st_["queries_amplitude"] == 8
        assert st_["batches"] == 2
        assert ps["prefix_misses"] == len(prefixes)
        assert ps["prefix_hits"] == len(prefixes)
        # a 3-row state absorbs one row per fresh prefix (row 0 is the base)
        assert st_["rows_absorbed"] == len(prefixes)


def test_threaded_stats_consistency(state33, state33b):
    with ServingEngine(window_ms=5.0) as eng:
        eng.register_state("a", state33, OPT)
        eng.register_state("b", state33b, OPT)
        per_state_prefixes = {"a": set(), "b": set()}
        futs = []
        rng = np.random.default_rng(14)
        for q in range(24):
            name = ("a", "b")[q % 2]
            bits = rng.integers(0, 2, (3, 3))
            per_state_prefixes[name].add(bits[:-1].tobytes())
            futs.append(eng.submit_amplitude(name, bits))
        for f in futs:
            f.result(timeout=120)
        st_ = eng.stats()
        assert st_["queries_amplitude"] == 24
        for name in ("a", "b"):
            ps = st_["per_state"][name]
            lookups = ps["prefix_hits"] + ps["prefix_misses"]
            assert len(per_state_prefixes[name]) <= lookups <= 12
            assert ps["prefix_misses"] == len(per_state_prefixes[name])


def test_submit_unknown_state_resolves_to_error(state33):
    with ServingEngine() as eng:
        eng.register_state("a", state33, OPT)
        fut = eng.submit_amplitude("nope", np.zeros((3, 3), dtype=int))
        with pytest.raises(KeyError):
            fut.result(timeout=120)
        fut = eng.submit_expectation("nope", Observable.Z(0))
        with pytest.raises(KeyError):
            fut.result(timeout=120)
        # the engine survives: later queries still serve
        good = eng.submit_amplitude("a", np.zeros((3, 3), dtype=int))
        complex(good.result(timeout=120))


def test_submit_bad_shape_resolves_to_error(state33):
    with ServingEngine() as eng:
        eng.register_state("a", state33, OPT)
        fut = eng.submit_amplitude("a", np.zeros((2, 2), dtype=int))
        with pytest.raises(ValueError):
            fut.result(timeout=120)
        with pytest.raises(ValueError):
            eng.amplitude_batch("a", np.zeros((2, 4), dtype=int))


# ---------------------------------------------------------------------------
# Cache lifecycle
# ---------------------------------------------------------------------------

def test_reregister_invalidates_prefix_envs(state33, state33b):
    bits = _bits(state33, 3, seed=15)
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, OPT)
        old = to_numpy(eng.amplitude_batch("s", bits))
        eng.register_state("s", state33b, OPT)
        new = eng.amplitude_batch("s", bits)
        want = _direct(state33b, bits)
        # the two states disagree, so a stale environment would show
        assert np.abs(old - want).max() > 1e-6
        _assert_close(new, want)


def test_reregister_bumps_version_and_counters(state33, state33b):
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, OPT)
        eng.amplitude_batch("s", _bits(state33, 2, seed=16))
        assert eng.stats()["per_state"]["s"]["version"] == 0
        eng.register_state("s", state33b, OPT)
        st_ = eng.stats()
        assert st_["per_state"]["s"]["version"] == 1
        assert st_["invalidations"] == 1
        assert st_["per_state"]["s"]["prefix_size"] == 0  # fresh cache


def test_max_states_lru_eviction_rematerializes(state33, state33b, state23):
    bits33 = _bits(state33, 2, seed=17)
    with ServingEngine(start=False, max_states=1) as eng:
        eng.register_state("a", state33, OPT)
        eng.register_state("b", state33b, OPT)
        eng.register_state("c", state23, OPT)
        first = eng.amplitude_batch("a", bits33)
        eng.amplitude_batch("b", bits33)  # evicts a's caches
        st_ = eng.stats()
        assert st_["state_evictions"] == 1
        assert st_["per_state"]["a"]["materialized"] is False
        assert st_["per_state"]["a"]["prefix_size"] == 0
        assert st_["per_state"]["b"]["materialized"] is True
        # "a" stays registered; the next query re-materializes, same values
        again = eng.amplitude_batch("a", bits33)
        assert torch.equal(first, again)
        _assert_close(again, _direct(state33, bits33))


def test_prefix_lru_eviction_recomputes(state33):
    bits = _bits(state33, 6, seed=18)  # distinct prefixes overflow cache=2
    with ServingEngine(start=False, max_prefixes=2) as eng:
        eng.register_state("s", state33, OPT)
        first = eng.amplitude_batch("s", bits)
        st_ = eng.stats()["per_state"]["s"]
        assert st_["prefix_evictions"] > 0
        assert st_["prefix_size"] <= 2
        again = eng.amplitude_batch("s", bits)
        assert torch.equal(first, again)
        _assert_close(again, _direct(state33, bits))


def test_eviction_never_corrupts_inflight(state33, state33b):
    """Churn registrations and state eviction while a client queries."""
    bits = _bits(state33, 2, seed=19)
    want = _direct(state33, bits)
    stop = threading.Event()
    errors = []

    with ServingEngine(window_ms=0.5, max_states=1) as eng:
        eng.register_state("a", state33, OPT)
        eng.register_state("b", state33b, OPT)

        def churn():
            while not stop.is_set():
                # same tensors re-registered: values must be unaffected
                eng.register_state("a", state33, OPT)
                eng.amplitude_batch("b", bits)  # evicts a's caches

        t = threading.Thread(target=churn)
        t.start()
        try:
            for _ in range(8):
                futs = [eng.submit_amplitude("a", b) for b in bits]
                got = np.array([complex(f.result(timeout=120)) for f in futs])
                if np.abs(got - want).max() > 1e-10 * max(1.0, np.abs(want).max()):
                    errors.append(got)
        finally:
            stop.set()
            t.join(timeout=120)
        assert not t.is_alive()
        assert eng.stats()["state_evictions"] > 0
    assert not errors


def test_unregister(state33):
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, OPT)
        eng.unregister("s")
        with pytest.raises(KeyError):
            eng.amplitude("s", np.zeros((3, 3), dtype=int))
        with pytest.raises(KeyError):
            eng.unregister("s")
        assert eng.registered() == []


# ---------------------------------------------------------------------------
# Infrastructure: bucketing, stats, fused-cache reuse, lifecycle
# ---------------------------------------------------------------------------

def test_stats_keys_present_before_any_query():
    with ServingEngine(start=False) as eng:
        st_ = eng.stats()
        for key in ("queries_amplitude", "queries_expectation", "batches",
                    "rows_absorbed", "state_evictions", "invalidations",
                    "padded_queries", "per_state", "states"):
            assert key in st_
        assert st_["states"] == 0


def test_chunk_ladder():
    eng = ServingEngine(start=False, bucket_sizes=(1, 2, 4))
    assert eng._chunks(1) == [1]
    assert eng._chunks(3) == [4]
    assert eng._chunks(4) == [4]
    assert eng._chunks(5) == [4, 1]
    assert eng._chunks(11) == [4, 4, 4]
    eng.close()
    assert DEFAULT_BUCKETS == tuple(sorted(DEFAULT_BUCKETS))


def test_padding_counter(state33):
    with ServingEngine(start=False, bucket_sizes=(4,)) as eng:
        eng.register_state("s", state33, OPT)
        bits = _bits(state33, 3, seed=20)
        bits[:, :-1] = bits[0, :-1]  # one group of 3 -> one padded 4-bucket
        out = eng.amplitude_batch("s", bits)
        assert out.shape == (3,)
        assert eng.stats()["padded_queries"] == 1
        _assert_close(out, _direct(state33, bits))


def test_fused_close_cache_reuse(state33):
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, OPT)
        bits = _bits(state33, 4, seed=21)
        bits[:, :-1] = bits[0, :-1]
        eng.amplitude_batch("s", bits)  # builds the close's entry
        before = planner.stats()
        eng.amplitude_batch("s", bits)
        delta = planner.stats_since(before)
        assert delta["fused_misses"] == 0
        assert delta["fused_hits"] >= 1


def test_obs_env_cache_counters(state33):
    obs = Observable.Z(0)
    with ServingEngine(start=False) as eng:
        eng.register_state("s", state33, OPT)
        eng.expectation("s", obs)
        eng.expectation("s", obs)
        ps = eng.stats()["per_state"]["s"]
        assert ps["obs_env_builds"] == 1
        assert ps["obs_env_hits"] == 1
        assert eng.stats()["queries_expectation"] == 2


def test_close_is_idempotent_and_blocks_submit(state33):
    eng = ServingEngine()
    eng.register_state("s", state33, OPT)
    eng.close()
    eng.close()  # idempotent
    with pytest.raises(RuntimeError):
        eng.submit_amplitude("s", np.zeros((3, 3), dtype=int))
    with pytest.raises(RuntimeError):
        eng.submit_expectation("s", Observable.Z(0))
    with pytest.raises(RuntimeError):
        eng.register_state("t", state33, OPT)


def test_pending_requests_drain_on_close(state33):
    eng = ServingEngine(window_ms=50.0)
    eng.register_state("s", state33, OPT)
    bits = _bits(state33, 6, seed=22)
    futs = [eng.submit_amplitude("s", b) for b in bits]
    eng.close()  # must drain, not drop
    assert all(f.done() for f in futs)
    got = np.array([complex(f.result(timeout=120)) for f in futs])
    _assert_close(got, _direct(state33, bits))


def test_constructor_validation():
    with pytest.raises(ValueError):
        ServingEngine(max_states=0)
    with pytest.raises(ValueError):
        ServingEngine(bucket_sizes=())
    with pytest.raises(ValueError):
        ServingEngine(bucket_sizes=(0, 2))


def test_lru_cache_unit():
    c = LRUCache(2)
    assert c.get("x") is None          # counted miss
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1             # counted hit, refreshes "a"
    c.put("c", 3)                      # evicts "b" (LRU)
    assert c.peek("b") is None         # peek: uncounted
    assert c.peek("a") == 1
    s = c.stats()
    assert (s["hits"], s["misses"], s["evictions"], s["size"]) == (1, 1, 1, 2)
    with pytest.raises(ValueError):
        LRUCache(0)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launch_serve_main_on_the_cpu(capsys):
    st_ = serve.main(["--grid", "3", "--layers", "4", "--chi", "4",
                      "--states", "2", "--clients", "2", "--queries", "6",
                      "--baseline-queries", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "q/s" in out and "p50=" in out and "cold contraction" in out
    assert st_["queries_amplitude"] + st_["queries_expectation"] >= 12
    assert set(st_["per_state"]) == {"rqc0", "rqc1"}
    for ps in st_["per_state"].values():
        assert ps["prefix_misses"] <= 4    # --hot-prefixes default


def test_launch_serve_states_match_reference_circuits():
    """The launcher's states are the reference's RQC states."""
    from repro.core.circuits import apply_circuit_exact_peps, random_circuit
    want = apply_circuit_exact_peps(RP.computational_zeros(3, 3),
                                    random_circuit(3, 3, 4, seed=8))
    got = serve.build_states(2, 3, 4, device=CPU)[1]
    assert got.dtype == torch.complex128
    assert rel_err(to_numpy(P.to_statevector(got)),
                   RP.to_statevector(want)) <= 1e-12
