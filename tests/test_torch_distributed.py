"""The port's column-sharded contraction (``repro_torch.core.distributed``)
against the reference's ``repro.core.distributed``, c128 on the CPU.

The contract of both packages: for any ``(n_shards, block)`` the sharded
sweep runs the single-device einsumsvd sequence.  So the port's sharded
norms equal its single-device ones at 1e-10 over the reference's whole
layout grid and its 6x8 acceptance case, the environment levels are bit
for bit the single-device ones, and norms, amplitudes, inner products,
expectations, environments and full-update sites match the reference's
distributed values at 1e-10 on ``JaxKey``s.  The comparisons with the
reference run where the two packages' *single-device* sweeps agree at
1e-10: at a truncation that keeps nearly degenerate directions (a
DirectSVD cut inside a cluster of singular values, or a randomized sketch
wider than the operator's numerical rank, whose Gram-QR then
orthogonalizes rounding noise) the two packages' single-device values
already part at 1e-5 to 1e-3, sharded or not.  Shards wrap round-robin
onto the one CPU device, so every layout runs here.  The layout rules, the
``for_mesh`` batch column (on ``torch.device`` descriptors, no
allocation), planner replay after a single-device warm-up, the halo byte
count, the row-local variational engine, the three wavefront modes
(``"spmd"`` and ``"auto"`` equal to ``"host"``; ``tests/test_torch_spmd.py``
holds the superstep itself) and the refusals (batched amplitudes, prefix
environments, serving) are held too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import CPU, JaxKey, port_to_ref, rel_err, \
    to_numpy  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.core import gates as RG  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core.environments import top_environments as r_top_envs  # noqa: E402
from repro.core.expectation import expectation as r_expectation  # noqa: E402
from repro.core.observable import Observable as RObs  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core import spmd  # noqa: E402
from repro_torch.core.environments import onelayer_prefix_environment, \
    top_environments  # noqa: E402
from repro_torch.core.expectation import expectation  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import Observable as TObs  # noqa: E402
from repro_torch.core.serving import ServingEngine  # noqa: E402
from repro_torch.launch.mesh import peps_mesh  # noqa: E402

TOL = 1e-10
NITER, OVERSAMPLE = 2, 4


def _rel(a, b):
    a, b = complex(a), complex(b)
    return abs(a - b) / max(abs(b), 1e-300)


def _port_state(nrow, ncol, bond, seed=3, scale=2.0):
    """A random state scaled as the reference's tests scale theirs
    (``tests/test_distributed.py``), drawn by the port: JAX compiles
    nothing for it."""
    gen = torch.Generator().manual_seed(seed)
    s = TP.random_peps(nrow, ncol, bond, gen, device=CPU)
    return TP.PEPS([[t * scale for t in row] for row in s.sites])


def _state(nrow, ncol, bond, seed=3, scale=2.0):
    """:func:`_port_state` in both packages (the reference's a copy)."""
    state = _port_state(nrow, ncol, bond, seed, scale)
    return port_to_ref(state), state


def _overlap(level, xp):
    """<E|E> of a two-layer boundary level: invariant under the bond
    gauges (the phases of each SVD's vectors) that the two packages'
    LAPACK routines choose each their own way."""
    acc = xp.ones((1, 1), dtype=complex)
    for t in level:
        acc = xp.einsum("ab,aijc,bijd->cd", acc, t, t.conj())
    return complex(acc.reshape(()))


def _options(chi, direct=False, **kw):
    """(reference, port) distributed options, randomized or DirectSVD; the
    port's shards on the CPU."""
    if direct:
        return (RD.DistributedBMPS(chi, **kw),
                TD.DistributedBMPS(chi, devices=(CPU,), **kw))
    return (RD.DistributedBMPS.randomized(chi, niter=NITER,
                                          oversample=OVERSAMPLE, fused=False,
                                          **kw),
            TD.DistributedBMPS.randomized(chi, niter=NITER,
                                          oversample=OVERSAMPLE,
                                          devices=(CPU,), **kw))


def _single(chi, direct=False, **kw):
    """The port's single-device option of :func:`_options`."""
    if direct:
        return TB.BMPS(chi, **kw)
    return TB.BMPS.randomized(chi, niter=NITER, oversample=OVERSAMPLE, **kw)


@pytest.fixture(scope="module")
def s23():
    return _state(2, 3, 2)


# ------------------------------------------------------------- layout ----

LAYOUTS = [(8, 4, 1), (8, 4, 2), (5, 2, 2), (7, 3, 1), (6, 8, 1), (1, 1, 1),
           (9, 4, 2)]


@pytest.mark.parametrize("ncol,n_shards,block", LAYOUTS)
def test_layout_partitions_columns_as_the_reference(ncol, n_shards, block):
    lay = TD.ColumnLayout(ncol, n_shards, block)
    ref = RD.ColumnLayout(ncol, n_shards, block)
    assert [(s, list(c)) for s, c in lay.blocks] == \
        [(s, list(c)) for s, c in ref.blocks]
    assert [c for _, cols in lay.blocks for c in cols] == list(range(ncol))
    assert [lay.owner(c) for c in range(ncol)] == \
        [(c // block) % n_shards for c in range(ncol)]


def test_layout_block_cyclic_wraps_and_rejects_garbage():
    assert [s for s, _ in TD.ColumnLayout(8, 4, 1).blocks] == \
        [0, 1, 2, 3, 0, 1, 2, 3]
    assert [s for s, _ in TD.ColumnLayout(8, 4, 2).blocks] == [0, 1, 2, 3]
    for bad in [(0, 1, 1), (4, 1, 0), (4, 0, 1)]:
        with pytest.raises(ValueError):
            TD.ColumnLayout(*bad)


def test_resolve_clamps_and_keeps_the_device_type():
    lay, devs = TD.DistributedBMPS(chi=8, n_shards=64).resolve(5, CPU)
    assert (lay.ncol, lay.n_shards, lay.block) == (5, 5, 1)
    assert devs == (torch.device(CPU),)
    lay, _ = TD.DistributedBMPS(chi=8, n_shards=2).resolve(5, CPU)
    assert (lay.n_shards, lay.block) == (2, 3)
    with pytest.raises(ValueError, match="nothing moves"):
        TD.DistributedBMPS(8, devices=("cuda:0",)).resolve(4, CPU)


def test_put_columns_keeps_resident_tensors(s23):
    _, state = s23
    lay, devs = TD.DistributedBMPS(4, n_shards=2, block=1).resolve(3, CPU)
    grid = TD.put_columns(state.sites, lay, devs)
    assert all(a is b for r0, r1 in zip(grid, state.sites)
               for a, b in zip(r0, r1))
    assert all(a is b for a, b in zip(TD.gather_columns(grid[0], devs[0]),
                                      grid[0]))


def test_for_mesh_selects_batch_column():
    cards = [torch.device("cuda", i) for i in range(4)]
    mesh = peps_mesh(2, 2, devices=cards)
    assert mesh.shape == {"col": 2, "batch": 2} and mesh.size == 4
    col0 = TD.DistributedBMPS.for_mesh(mesh, chi=8)
    col1 = TD.DistributedBMPS.for_mesh(mesh, chi=8, batch_index=1)
    assert col0.devices == (cards[0], cards[2]) and col0.n_shards == 2
    assert col1.devices == (cards[1], cards[3])
    assert TD.DistributedBMPS.for_mesh(mesh, 8, batch_index=3).devices == \
        col1.devices
    # fewer devices than cells wrap round-robin
    assert TD.DistributedBMPS.for_mesh(peps_mesh(2, 2, devices=cards[:3]),
                                       8, batch_index=1).devices == \
        (cards[1], cards[0])


# ---------------------------------------------- port == reference -------

GRID = [
    # nrow, ncol, bond, chi, n_shards, block (the reference's grid)
    (3, 4, 2, 8, 2, None),      # even split, pure block layout
    (3, 5, 2, 8, 2, 2),         # ncol not divisible by n_shards
    (4, 6, 2, 8, 4, 1),         # block-cyclic, width 1
    (2, 3, 2, 4, 3, None),      # one column per shard
    (3, 4, 2, 6, 8, 1),         # more shards than columns (clamped)
]
# the grid's case that the other comparisons with the reference share
# (its sweeps compile once; the 3x4 and wider cases hold port against
# port above, a 3x4 sweep of the reference compiling for 5 s)
REFERENCE_CASES = (3,)


@pytest.mark.parametrize("nrow,ncol,bond,chi,n_shards,block", GRID)
@pytest.mark.parametrize("direct", [False, True], ids=["rsvd", "direct"])
def test_norm_squared_matches_single_device(nrow, ncol, bond, chi, n_shards,
                                            block, direct):
    state = _port_state(nrow, ncol, bond)
    _, topt = _options(chi, direct, n_shards=n_shards, block=block)
    got = TB.norm_squared(state, topt, TorchKey(7))
    single = TB.norm_squared(state, _single(chi, direct), TorchKey(7))
    assert _rel(got, single) <= TOL


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_norm_squared_matches_reference(case):
    nrow, ncol, bond, chi, n_shards, block = GRID[case]
    ref, state = _state(nrow, ncol, bond)
    ropt, topt = _options(chi, True, n_shards=n_shards, block=block)
    want = RB.norm_squared(ref, ropt, jax.random.PRNGKey(7))
    got = TB.norm_squared(state, topt, JaxKey(7))
    assert _rel(got, want) <= TOL


def test_amplitude_matches_reference(s23):
    ref, state = s23
    bits = np.arange(6) % 2
    ropt, topt = _options(4, True, n_shards=3, block=1)
    want = RB.amplitude(ref, bits, ropt, jax.random.PRNGKey(9))
    got = TB.amplitude(state, bits, topt, JaxKey(9))
    assert _rel(got, want) <= TOL


def test_inner_matches_reference(s23):
    bra_ref, bra = s23
    ket_ref, ket = _state(2, 3, 2, seed=4)
    ropt, topt = _options(4, direct=True, n_shards=3)
    want = RB.inner(bra_ref, ket_ref, ropt, jax.random.PRNGKey(1))
    got = TB.inner(bra, ket, topt, JaxKey(1))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("direct", [False, True], ids=["rsvd", "direct"])
def test_environments_bit_for_bit_single_device(direct):
    state = _port_state(3, 5, 2)
    _, topt = _options(8, direct, n_shards=2, block=2)
    got = top_environments(state.sites, state.sites, topt, TorchKey(4))
    single = top_environments(state.sites, state.sites, _single(8, direct),
                              TorchKey(4))
    assert len(got) == len(single) == 4
    for lg, ls in zip(got, single):
        assert all(torch.equal(tg, ts) for tg, ts in zip(lg, ls))


def test_environments_match_reference(s23):
    ref, state = s23
    ropt, topt = _options(4, direct=True, n_shards=3, block=1)
    got = top_environments(state.sites, state.sites, topt, JaxKey(4))
    single = top_environments(state.sites, state.sites, _single(4, True),
                              JaxKey(4))
    want = r_top_envs(ref.sites, ref.sites, ropt, jax.random.PRNGKey(4))
    assert len(got) == len(single) == len(want) == 3
    for lg, ls, lw in zip(got, single, want):
        assert all(torch.equal(tg, ts) for tg, ts in zip(lg, ls))
        assert _rel(_overlap(lg, torch), _overlap(lw, jax.numpy)) <= TOL


def test_expectation_matches_reference(s23):
    ref, state = s23
    ropt, topt = _options(4, direct=True, n_shards=3, block=1)
    rh = RObs.ZZ(0, 1) + 0.3 * RObs.X(2) + RObs.ZZ(1, 4)
    th = TObs.ZZ(0, 1) + 0.3 * TObs.X(2) + TObs.ZZ(1, 4)
    want = r_expectation(ref, rh, ropt, key=jax.random.PRNGKey(2))
    got = expectation(state, th, topt, key=JaxKey(2))
    assert _rel(got, want) <= TOL


def test_full_update_env_contract_matches_reference(s23):
    ref, state = s23
    want = RP.apply_operator(
        ref, RG.gate("CX"), [1, 4],
        RP.FullUpdate(rank=2, chi=4,
                      env_contract=RD.DistributedBMPS(4, n_shards=3, block=1)),
        key=jax.random.PRNGKey(5))
    got = TP.apply_operator(
        state, RG.gate("CX"), [1, 4],
        TP.FullUpdate(rank=2, chi=4, env_contract=TD.DistributedBMPS(
            4, n_shards=3, block=1, devices=(CPU,))),
        key=JaxKey(5))
    # the sites carry each package's SVD signs: compare the states
    assert rel_err(to_numpy(TP.to_statevector(got)),
                   RP.to_statevector(want)) <= TOL


def test_acceptance_6x8_chi16_8shards():
    """The reference's acceptance case: 6x8 D=2 chi=16, 8 column shards,
    against the single-device sweep (there the packages' single-device
    values part at 4e-2: see the module docstring)."""
    state = _port_state(6, 8, 2, scale=2.2)
    _, topt = _options(16, n_shards=8, block=1)
    got = TB.norm_squared(state, topt, TorchKey(7))
    single = TB.norm_squared(state, _single(16), TorchKey(7))
    assert _rel(got, single) <= TOL


# ------------------------------------------- port-only properties -------

def test_planner_cache_reused_across_shards():
    """After a single-device warm-up a sharded sweep of the same lattice
    replays every fused callable and einsum path: the planner's
    signatures carry the device type, not the shard."""
    planner.clear()
    try:
        state = _port_state(4, 6, 2)
        TB.norm_squared(state, TB.BMPS.randomized(8), TorchKey(7))
        before = planner.stats()
        for n_shards, block in [(4, 1), (2, 2)]:
            TB.norm_squared(state, TD.DistributedBMPS.randomized(
                8, n_shards=n_shards, block=block, devices=(CPU,)),
                TorchKey(7))
        delta = planner.stats_since(before)
        assert delta["fused_misses"] == 0, delta
        assert delta["path_misses"] == 0, delta
        assert delta["fused_hits"] > 0
    finally:
        planner.clear()


def test_halo_bytes_per_row_as_the_reference():
    ref, state = _state(4, 8, 2)
    for n_shards, block in [(2, 4), (8, 1), (1, 1), (4, 1)]:
        got = TD.halo_bytes_per_row(state, TD.DistributedBMPS(
            16, n_shards=n_shards, block=block, devices=(CPU,)))
        want = RD.halo_bytes_per_row(ref, RD.DistributedBMPS(
            16, n_shards=n_shards, block=block))
        assert got == want
    one = TD.halo_bytes_per_row(state, TD.DistributedBMPS(
        16, n_shards=2, block=4, devices=(CPU,)))
    # one edge: a (16, 2, 2, 16, 2, 2) carry and a (16, 2, 2, 16) boundary
    # tensor, 16 bytes an entry
    assert one == (16 * 4 * 16 * 4 + 16 * 4 * 16) * 16
    thin = _port_state(3, 1, 2)
    assert TD.halo_bytes_per_row(thin, TD.DistributedBMPS(
        16, devices=(CPU,))) == 0


def test_variational_engine_runs_row_local():
    ref, state = _state(2, 3, 2, seed=6)
    ropt, topt = _options(4, True, n_shards=3, block=1, engine="variational")
    want = RB.norm_squared(ref, ropt, jax.random.PRNGKey(5))
    got = TB.norm_squared(state, topt, JaxKey(5))
    assert _rel(got, want) <= TOL
    single = TB.norm_squared(state, _single(4, True, engine="variational"),
                             JaxKey(5))
    assert _rel(got, single) <= TOL


def test_wavefront_modes():
    with pytest.raises(ValueError, match="wavefront"):
        TD.DistributedBMPS(8, wavefront="pipelined")
    with pytest.raises(ValueError, match="supports_blocks=False"):
        TD.DistributedBMPS(8, wavefront="auto", engine="variational")
    with pytest.raises(ValueError, match="supports_blocks=False"):
        TD.DistributedBMPS(8, wavefront="spmd", engine="variational")
    # rows 1 and 2 are chi-saturated: "spmd" runs them in the superstep
    state = _port_state(4, 6, 2)
    spmd.reset_stats()
    vals = [TB.norm_squared(state, TD.DistributedBMPS(
        4, n_shards=3, wavefront=w, devices=(CPU,)), TorchKey(1))
        for w in ("host", "auto", "spmd")]
    assert spmd.stats()["rows_spmd"] == 2
    assert torch.equal(vals[0], vals[1]) and torch.equal(vals[0], vals[2])


def test_single_device_entry_points_reject_the_option(s23):
    _, state = s23
    opt = TD.DistributedBMPS(4, n_shards=2, devices=(CPU,))
    with pytest.raises(TypeError, match="single-device"):
        TB.amplitudes(state, np.zeros((2, 6), dtype=int), opt)
    with pytest.raises(TypeError, match="single-device"):
        onelayer_prefix_environment(state, [[0] * 3], opt)
    with ServingEngine(start=False) as eng:
        with pytest.raises(TypeError, match="single-device BMPS"):
            eng.register_state("d", state, opt)
    with pytest.raises(TypeError, match="BMPS or DistributedBMPS"):
        TB.norm_squared(state, object())
