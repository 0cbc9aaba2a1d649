"""The port's wavefront superstep (``repro_torch.core.spmd``) against the
reference's ``repro.core.spmd`` and against the port's host pipeline,
c128 on the CPU.

The contract of both packages: for chi-saturated rows the superstep runs
the einsumsvd sequence of the host pipeline and of the single-device
sweep, so ``wavefront`` is pure scheduling.  Here the port's plans equal
the reference's ``_make_plan`` plans (their shape programs too, at the
reference's grid and at the 8x8 D=6 chi-64 main path's shapes), the
superstep's boundary levels equal the host pipeline's bit for bit, its
scalars lie within 1e-10 of single-device and, on ``JaxKey``s where the
two packages' single-device sweeps agree (DirectSVD at chi 4: ROADMAP §3
item 4), of the reference's, and its row counts equal the reference's.
Shards wrap onto the one CPU device, so the multi-shard wavefront runs
here as several worker threads.  The thread-safety repairs the workers
need (counters, the planner's caches, the kernel library's build, the
dispatcher's scoped state) are held under stress, and a worker that
raises fails the call and leaves no worker behind.  Most cases compare
port against port: a reference sweep costs seconds of compiling.
"""
import sys
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import CPU, JaxKey, port_to_ref  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import spmd as RS  # noqa: E402
from repro.core.einsumsvd import DirectSVD as RDirect  # noqa: E402
from repro.core.environments import top_environments as r_top_envs  # noqa: E402
from repro.core.expectation import expectation as r_expectation  # noqa: E402
from repro.core.observable import Observable as RObs  # noqa: E402
from repro_torch import counting  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core import planner, spmd  # noqa: E402
from repro_torch.core.environments import top_environments  # noqa: E402
from repro_torch.core.expectation import expectation  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import Observable as TObs  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels import gram as KG  # noqa: E402

TOL = 1e-10
NITER, OVERSAMPLE = 2, 4
# a worker that raises must fail the call within this many seconds
FAIL_WITHIN_S = 60


def _rel(a, b):
    a, b = complex(a), complex(b)
    return abs(a - b) / max(abs(b), 1e-300)


def _state(nrow, ncol, bond, seed=3, scale=2.0, dtype=torch.complex128):
    """A random state scaled as the reference's tests scale theirs."""
    gen = torch.Generator().manual_seed(seed)
    s = TP.random_peps(nrow, ncol, bond, gen, dtype=dtype, device=CPU)
    return TP.PEPS([[t * scale for t in row] for row in s.sites])


def _opt(chi, mode, n_shards=4, block=None, direct=False):
    if direct:
        return TD.DistributedBMPS(chi, n_shards=n_shards, block=block,
                                  wavefront=mode, devices=(CPU,))
    return TD.DistributedBMPS.randomized(
        chi, niter=NITER, oversample=OVERSAMPLE, n_shards=n_shards,
        block=block, wavefront=mode, devices=(CPU,))


def _single(chi):
    return TB.BMPS.randomized(chi, niter=NITER, oversample=OVERSAMPLE)


def _quiet(fn):
    """``fn()`` with the never-engaged warning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn()


@pytest.fixture(autouse=True)
def _fresh_spmd():
    spmd.clear()
    yield
    spmd.clear()


# --------------------------------------------------- plans == reference ----

def _site_shape(i, j, nrow, ncol, bond, phys=2):
    return (phys, 1 if i == 0 else bond, 1 if j == 0 else bond,
            1 if i == nrow - 1 else bond, 1 if j == ncol - 1 else bond)


# the reference's GRID (tests/test_spmd.py), its bond-1 lattice, and the
# main path's 8x8 D=6 chi-64 lattice
PLAN_CASES = [(5, 8, 2, 8, 2), (5, 12, 2, 8, 4), (4, 13, 2, 8, 4),
              (4, 10, 2, 6, 4), (5, 8, 1, 4, 4), (6, 8, 2, 16, 8),
              (8, 8, 6, 64, 4)]


@pytest.mark.parametrize("nrow,ncol,bond,chi,n_shards", PLAN_CASES)
def test_plans_equal_the_reference(nrow, ncol, bond, chi, n_shards):
    """Row by row through a two-layer sweep's boundary shapes: the port's
    shape program equals the reference's ``_eval_row`` (``jax.eval_shape``
    of its micro-steps), and the port's plan the reference's
    ``_make_plan`` with ``ndev = n_shards``, under "spmd" and "auto".  The
    reference traces DirectSVD micro-steps, ten times cheaper than
    randomized ones: both keep ``min(chi, rows, columns)``."""
    rsvd = RDirect()
    dtype = jax.numpy.complex128
    sv = ((1, 1, 1, 1),) * ncol
    planned = 0
    for i in range(nrow):
        sites = tuple((_site_shape(i, j, nrow, ncol, bond),) * 2
                      for j in range(ncol))
        if i == 1 and (nrow, ncol, bond, chi) == (8, 8, 6, 64):
            # the main path: two shards of four columns from row 1 on
            p = spmd._make_plan(spmd.TWO_LAYER, chi, sv, sites,
                                torch.complex64, n_shards, False)
            assert (p.n, p.w, p.jl, p.jr) == (2, 4, 3, 6)
        emits, vins = spmd._eval_row(spmd.TWO_LAYER, chi, sv, sites)
        r_emits, r_vins = RS._eval_row(RS.TWO_LAYER, chi, rsvd, sv, sites,
                                       dtype)
        assert [tuple(e) for e in emits] == [tuple(e) for e in r_emits]
        assert vins == r_vins
        for single in (True, False):
            got = spmd._make_plan(spmd.TWO_LAYER, chi, sv, sites,
                                  torch.complex128, n_shards, single)
            want = RS._make_plan(RS.TWO_LAYER, chi, rsvd, sv, sites, dtype,
                                 n_shards, n_shards, single)
            assert (got is None) == (want is None), (i, got, want)
            if got is not None:
                planned += 1
                for f in ("ncol", "n", "w", "jl", "jr", "sv_shapes",
                          "site_shapes", "sv_u", "site_u", "v_u"):
                    assert getattr(got, f) == getattr(want, f), (i, f)
                assert got.dtype == want.dtype == "complex128"
        sv = tuple(tuple(e) for e in emits)
    assert planned > 0


def test_onelayer_plan_equals_the_reference():
    rsvd = RDirect()
    nrow, ncol = 5, 12
    sites = [tuple((_site_shape(i, j, nrow, ncol, 2)[1:],)
                   for j in range(ncol)) for i in range(nrow)]
    sv = tuple((s[0][1], s[0][2], s[0][3]) for s in sites[0])
    for i in range(1, nrow):
        got = spmd._make_plan(spmd.ONE_LAYER, 4, sv, sites[i],
                              torch.complex128, 4, True)
        want = RS._make_plan(RS.ONE_LAYER, 4, rsvd, sv, sites[i],
                             jax.numpy.complex128, 4, 4, True)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.n, got.w, got.jl, got.jr, got.v_u) == \
                (want.n, want.w, want.jl, want.jr, want.v_u)
        sv = tuple(tuple(e) for e in
                   spmd._eval_row(spmd.ONE_LAYER, 4, sv, sites[i])[0])


def _reference_counts(nrow, ncol, bond, chi, n_shards):
    """(rows_spmd, rows_host, superstep_calls) of the reference's "spmd"
    sweep, from its own ``plan_run`` on shape structs (plans only)."""
    S = lambda sh: jax.ShapeDtypeStruct(tuple(sh), jax.numpy.complex128)
    grid = [[S(_site_shape(i, j, nrow, ncol, bond)) for j in range(ncol)]
            for i in range(nrow)]
    rsvd = RDirect()
    sv = ((1, 1, 1, 1),) * ncol
    spmd_rows = host_rows = calls = 0
    i = 0
    while i < nrow:
        run, _ = RS.plan_run(RS.TWO_LAYER, [S(s) for s in sv], (grid, grid),
                             i, chi, rsvd, n_shards, tuple(jax.devices()),
                             "spmd")
        if run:
            spmd_rows, calls = spmd_rows + run, calls + 1
        else:
            host_rows += 1
        for r in range(i, i + max(run, 1)):
            sites = tuple((tuple(grid[r][c].shape),) * 2
                          for c in range(ncol))
            sv = tuple(tuple(e) for e in
                       RS._eval_row(RS.TWO_LAYER, chi, rsvd, sv, sites,
                                    jax.numpy.complex128)[0])
        i += max(run, 1)
    return spmd_rows, host_rows, calls


@pytest.mark.parametrize("nrow,ncol,chi,n_shards,scale",
                         [(6, 12, 8, 4, 2.0), (6, 8, 16, 8, 2.2)])
def test_row_counts_equal_the_reference(nrow, ncol, chi, n_shards, scale):
    """4 rows in the superstep and 2 on the host pipeline, in one call, at
    6x12 and at the 6x8 chi-16 8-shard case, as the reference counts."""
    state = _state(nrow, ncol, 2, scale=scale)
    key = TorchKey(7)
    single = TB.norm_squared(state, _single(chi), key)
    host = TB.norm_squared(state, _opt(chi, "host", n_shards), key)
    spmd.reset_stats()
    got = TB.norm_squared(state, _opt(chi, "spmd", n_shards), key)
    st = spmd.stats()
    want = _reference_counts(nrow, ncol, 2, chi, n_shards)
    assert (st["rows_spmd"], st["rows_host"], st["superstep_calls"]) == \
        want == (4, 2, 1)
    assert torch.equal(got, host)
    assert _rel(got, single) <= TOL


# ----------------------------------------------- superstep == host ------

GRID = [(5, 8, 2, 8, 2), (5, 12, 2, 8, 4), (4, 13, 2, 8, 4),
        (4, 10, 2, 6, 4), (5, 8, 1, 4, 4)]


@pytest.mark.parametrize("nrow,ncol,bond,chi,n_shards", GRID)
def test_norm_equals_the_host_pipeline(nrow, ncol, bond, chi, n_shards):
    state = _state(nrow, ncol, bond)
    key = TorchKey(7)
    single = TB.norm_squared(state, _single(chi), key)
    host = TB.norm_squared(state, _opt(chi, "host", n_shards), key)
    got = _quiet(lambda: TB.norm_squared(state, _opt(chi, "spmd", n_shards),
                                         key))
    assert spmd.stats()["rows_spmd"] > 0
    assert torch.equal(got, host)
    assert _rel(got, single) <= TOL


def test_layout_independent_of_host_blocking():
    state = _state(5, 12, 2)
    key = TorchKey(5)
    single = TB.norm_squared(state, _single(8), key)
    for n_shards, block in [(2, None), (4, 1), (3, 2)]:
        got = TB.norm_squared(state, _opt(8, "spmd", n_shards, block), key)
        assert _rel(got, single) <= TOL, (n_shards, block)


def test_environment_levels_bit_for_bit_the_host_pipeline():
    state = _state(5, 12, 2)
    got = top_environments(state.sites, state.sites, _opt(8, "spmd"),
                           TorchKey(4))
    host = top_environments(state.sites, state.sites, _opt(8, "host"),
                            TorchKey(4))
    single = top_environments(state.sites, state.sites, _single(8),
                              TorchKey(4))
    assert spmd.stats()["rows_spmd"] == 3
    assert len(got) == len(host) == len(single) == 6
    for lg, lh, ls in zip(got, host, single):
        assert all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(lg, lh, ls))


def test_amplitude_inner_expectation_equal_the_host_pipeline():
    bra, ket = _state(5, 12, 2), _state(5, 12, 2, seed=4)
    bits = np.arange(60) % 2
    spmd.reset_stats()
    amp = TB.amplitude(bra, bits, _opt(4, "spmd"), TorchKey(9))
    assert spmd.stats()["rows_spmd"] > 0       # the one-layer superstep
    assert torch.equal(amp, TB.amplitude(bra, bits, _opt(4, "host"),
                                         TorchKey(9)))
    assert _rel(amp, TB.amplitude(bra, bits, _single(4), TorchKey(9))) <= TOL
    inner = TB.inner(bra, ket, _opt(8, "spmd"), TorchKey(1))
    assert torch.equal(inner, TB.inner(bra, ket, _opt(8, "host"),
                                       TorchKey(1)))
    assert _rel(inner, TB.inner(bra, ket, _single(8), TorchKey(1))) <= TOL
    state = _state(5, 8, 2)
    h = (TObs.ZZ(9, 10) + 0.3 * TObs.X(2) + TObs.ZZ(1, 9)
         + 0.7 * TObs.Z(12))
    got = expectation(state, h, _opt(8, "spmd"), key=TorchKey(2))
    assert torch.equal(got, expectation(state, h, _opt(8, "host"),
                                        key=TorchKey(2)))
    assert _rel(got, expectation(state, h, _single(8),
                                 key=TorchKey(2))) <= TOL


def test_distributed_full_update_gate_equals_the_host_pipeline():
    from repro_torch.core import gates as TG
    state = _state(4, 6, 2)
    new = [TP.apply_operator(state, TG.gate("CX"), [7, 8], TP.FullUpdate(
        rank=2, chi=4, env_contract=_opt(4, mode, 3, direct=True)),
        key=TorchKey(5)) for mode in ("host", "spmd")]
    assert spmd.stats()["rows_spmd"] > 0
    assert all(torch.equal(a, b) for ra, rb in zip(new[0].sites, new[1].sites)
               for a, b in zip(ra, rb))


# ------------------------------------------------ port == reference -----

@pytest.fixture(scope="module")
def s46():
    """A 4x6 D=2 state in both packages: DirectSVD at chi 4 cuts between
    well-separated singular values, so the packages' single-device sweeps
    agree at 1e-15, and rows 1 and 2 run a two-shard wavefront."""
    state = _state(4, 6, 2)
    return port_to_ref(state), state


def _direct(mode="spmd"):
    return TD.DistributedBMPS(4, n_shards=3, wavefront=mode, devices=(CPU,))


def test_norm_and_amplitude_match_the_reference(s46):
    ref, state = s46
    got = TB.norm_squared(state, _direct(), JaxKey(7))
    assert spmd.stats()["rows_spmd"] == 2
    assert _rel(got, RB.norm_squared(ref, RB.BMPS(4),
                                     jax.random.PRNGKey(7))) <= TOL
    bits = np.arange(24) % 2
    spmd.reset_stats()
    got = TB.amplitude(state, bits, _direct(), JaxKey(9))
    assert spmd.stats()["rows_spmd"] == 1
    assert _rel(got, RB.amplitude(ref, bits, RB.BMPS(4),
                                  jax.random.PRNGKey(9))) <= TOL


def test_inner_environments_expectation_match_the_reference(s46):
    ref, state = s46
    ket = _state(4, 6, 2, seed=4)
    got = TB.inner(state, ket, _direct(), JaxKey(1))
    assert _rel(got, RB.inner(ref, port_to_ref(ket), RB.BMPS(4),
                              jax.random.PRNGKey(1))) <= TOL
    envs = top_environments(state.sites, state.sites, _direct(), JaxKey(4))
    want = r_top_envs(ref.sites, ref.sites, RB.BMPS(4),
                      jax.random.PRNGKey(4))

    def overlap(level, xp):
        acc = xp.ones((1, 1), dtype=complex)
        for t in level:
            acc = xp.einsum("ab,aijc,bijd->cd", acc, t, t.conj())
        return complex(acc.reshape(()))
    assert len(envs) == len(want) == 5
    for lg, lw in zip(envs, want):
        assert _rel(overlap(lg, torch), overlap(lw, jax.numpy)) <= TOL
    rh = RObs.ZZ(0, 1) + 0.3 * RObs.X(8) + RObs.ZZ(7, 13)
    th = TObs.ZZ(0, 1) + 0.3 * TObs.X(8) + TObs.ZZ(7, 13)
    got = expectation(state, th, _direct(), key=JaxKey(2))
    assert _rel(got, r_expectation(ref, rh, RB.BMPS(4),
                                   key=jax.random.PRNGKey(2))) <= TOL


# ------------------------------------------------------------ handoff ----

def test_auto_stays_on_the_host_pipeline_on_one_device():
    state = _state(6, 12, 2)
    key = TorchKey(7)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = TB.norm_squared(state, _opt(8, "auto"), key)
    st = spmd.stats()
    assert st["rows_spmd"] == 0 and st["rows_host"] == 6, st
    assert st["superstep_calls"] == 0 and st["fn_cache_size"] == 0
    assert torch.equal(got, TB.norm_squared(state, _opt(8, "host"), key))
    # the rule is the plan's shards on distinct devices, not the shards
    sv = [torch.ones((1, 1, 1, 1), dtype=torch.complex128)] * 12
    assert spmd.plan_run(spmd.TWO_LAYER, sv, (state.sites, state.sites), 0,
                         8, _opt(8, "auto").svd, 4, (torch.device(CPU),),
                         "auto") == (0, None)


def test_ramp_rows_never_enter_the_superstep():
    state = _state(4, 8, 2)
    trivial = [torch.ones((1, 1, 1, 1), dtype=torch.complex128)] * 8
    assert spmd.plan_run(spmd.TWO_LAYER, trivial, (state.sites, state.sites),
                         0, 8, _opt(8, "spmd").svd, 4,
                         (torch.device(CPU),), "spmd") == (0, None)


def test_spmd_warns_when_the_superstep_never_engaged():
    # 2 rows: row 0 ramps, row 1 is the last row: nothing is saturated
    state = _state(2, 6, 2)
    with pytest.warns(UserWarning, match="never engaged"):
        TB.norm_squared(state, _opt(8, "spmd"), TorchKey(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TB.norm_squared(state, _opt(8, "auto"), TorchKey(0))


def test_second_sweep_builds_no_schedule_and_no_plan():
    state = _state(5, 8, 2)
    TB.norm_squared(state, _opt(8, "spmd"), TorchKey(7))
    first = spmd.stats()
    assert first["superstep_builds"] == 1 and first["plans"] >= 1
    TB.norm_squared(state, _opt(8, "spmd"), TorchKey(7))
    second = spmd.stats()
    assert second["superstep_builds"] == first["superstep_builds"]
    assert second["plans"] == first["plans"]
    assert second["superstep_calls"] == first["superstep_calls"] + 1


def test_planner_replays_after_a_single_device_warm_up():
    planner.clear()
    try:
        state = _state(5, 8, 2)
        TB.norm_squared(state, _single(8), TorchKey(7))
        before = planner.stats()
        TB.norm_squared(state, _opt(8, "spmd"), TorchKey(7))
        delta = planner.stats_since(before)
        assert delta["fused_misses"] == 0 and delta["path_misses"] == 0, \
            delta
        assert delta["fused_hits"] > 0
    finally:
        planner.clear()


def test_counters_equal_the_host_sweep_under_threads():
    """A c64 sweep in forced kernel mode (the kernel sites run their plain
    versions on the CPU and count as kernel calls), from a cold planner,
    with the interpreter switching threads as often as it can: every
    planner, dispatch and guard counter of the "spmd" sweep equals the
    host sweep's."""
    state = _state(5, 8, 2, dtype=torch.complex64)
    prev_mode = dispatch.set_kernel_backend("kernel")
    prev_switch = sys.getswitchinterval()
    counts = {}
    try:
        sys.setswitchinterval(1e-6)
        for mode in ("host", "spmd", "host", "spmd"):
            planner.clear()
            TB.norm_squared(state, _opt(8, mode), TorchKey(3))
            counts.setdefault(mode, []).append(planner.stats())
    finally:
        sys.setswitchinterval(prev_switch)
        dispatch.set_kernel_backend(prev_mode)
        planner.clear()
    host, wave = counts["host"][0], counts["spmd"][0]
    assert spmd.stats()["rows_spmd"] == 6
    assert host["kernel_gram_calls"] > 0 and host["fused_misses"] > 0
    assert host == wave == counts["host"][1] == counts["spmd"][1]


def test_a_worker_that_raises_fails_the_call(monkeypatch):
    """Shard 1's micro-step raises: the caller re-raises that exception
    within FAIL_WITHIN_S, shard 0 (blocked on a halo) is woken, and no
    worker thread is left."""
    from repro_torch.core.runtime_guard import GuardExhaustedError
    step = spmd._Kernel.step

    def failing(self, *args, **kwargs):
        if threading.current_thread().name.startswith("repro-spmd-1-"):
            raise GuardExhaustedError("einsumsvd", "nan", 2, [])
        return step(self, *args, **kwargs)

    monkeypatch.setattr(spmd._Kernel, "step", failing)
    state = _state(5, 8, 2)
    out = {}

    def call():
        try:
            TB.norm_squared(state, _opt(8, "spmd", 2), TorchKey(7))
        except BaseException as e:  # noqa: BLE001 — asserted below
            out["error"] = e

    caller = threading.Thread(target=call)
    caller.start()
    caller.join(timeout=FAIL_WITHIN_S)
    assert not caller.is_alive()
    assert isinstance(out.get("error"), GuardExhaustedError), out
    assert not [t for t in threading.enumerate()
                if t.name.startswith("repro-spmd-")]
    assert spmd.stats()["superstep_calls"] == 0
    monkeypatch.setattr(spmd._Kernel, "step", step)
    # the next sweep starts new workers
    got = TB.norm_squared(state, _opt(8, "spmd", 2), TorchKey(7))
    assert torch.equal(got, TB.norm_squared(state, _opt(8, "host", 2),
                                            TorchKey(7)))


# ------------------------------------------- shared state under threads --

def _in_threads(fn, n=8):
    """``fn(i)`` in ``n`` threads at once, the interpreter switching as
    often as it can; each join has its own time limit."""
    prev = sys.getswitchinterval()
    errors = []
    barrier = threading.Barrier(n)

    def run(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    try:
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and not errors, errors


def test_counter_ticks_lose_nothing():
    counters = {"x": 0}
    before = KG.gram_complex.launches
    reps = 2000

    def tick(_):
        for _ in range(reps):
            counting.tick(counters, "x")
            counting.tick_attr(KG.gram_complex)
    _in_threads(tick)
    assert counters["x"] == 8 * reps
    assert KG.gram_complex.launches == before + 8 * reps
    KG.gram_complex.launches = before


def test_planner_caches_miss_once_per_signature_under_threads():
    planner.clear()
    try:
        exprs = ["ab,bc->ac", "abc,cd->abd", "ab,bc,cd->ad"]
        shapes = [((4, 5), (5, 6)), ((2, 3, 4), (4, 5)),
                  ((2, 3), (3, 4), (4, 5))]
        reps = 300

        def lookups(i):
            for r in range(reps):
                k = (i + r) % 3
                planner.contraction_path(exprs[k], shapes[k])
                planner.fused_fn("t", (k,), lambda: object())
        _in_threads(lookups)
        st = planner.stats()
        assert st["path_misses"] == 3 and st["fused_misses"] == 3, st
        assert st["path_hits"] == st["fused_hits"] == 8 * reps - 3
    finally:
        planner.clear()


def test_dispatch_counts_and_scoped_state_per_thread():
    s0 = torch.randn(1, 2, 3, dtype=torch.float64)
    o0 = torch.randn(2, 1, 2, 3, dtype=torch.float64)
    prev = dispatch.set_kernel_backend("dense")
    dispatch.reset_dispatch_stats()
    reps = 200
    try:
        def calls(i):
            # a scoped change in one thread is that thread's alone
            with dispatch.kernel_compute_scope(
                    "bfloat16" if i % 2 else None):
                with dispatch.forced_dense():
                    for _ in range(reps):
                        dispatch.dispatch("zipup_first_onelayer", s0, o0)
                        assert dispatch.kernel_backend() == "dense"
                        assert dispatch.kernel_compute() == (
                            "bfloat16" if i % 2 else None)
        dispatch.set_kernel_backend("auto")
        _in_threads(calls)
        assert dispatch.dispatch_stats()[
            "dense_zipup_first_onelayer_calls"] == 8 * reps
        assert dispatch.kernel_backend() == "auto"
        assert dispatch.kernel_compute() is None
    finally:
        dispatch.set_kernel_backend(prev)
        dispatch.reset_dispatch_stats()


def test_kernel_library_builds_once_for_threads_that_launch_at_once(
        monkeypatch):
    import ctypes.util
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for the kernel library")
    builds = []

    def fake_build():
        builds.append(threading.current_thread().name)
        return libc
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "_SIGNATURES", {})
    libs = []
    _in_threads(lambda i: libs.append(build.library()))
    assert len(builds) == 1 and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)
