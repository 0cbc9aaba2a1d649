"""The port's PEPS ensembles (``repro_torch.core.sharding``) and mesh-placed
VQE ensembles against the reference, c128 on the CPU.

``ensemble_sharding`` follows the reference's rule (the member axis over
every mesh axis, else the trailing axis that divides it, else replicated),
held on a mesh of ``torch.device("cuda", i)`` descriptors, which allocate
nothing.  ``batched_evolve``/``batched_contract`` run member after member
and equal the reference's per-member ``evolve_step``/``contract_step`` at
1e-10 on ``JaxKey``s (the members are the reference's ``random_peps`` of
seeds 0 and 1; in about one draw of six a gate's sketch is wider than its
operator's numerical rank, and there the two packages part at 1e-5 to
1e-3, sharded or not: ROADMAP §3 item 4); ``run_vqe(mesh=...)`` equals
the unplaced run bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import CPU, JaxKey, ref_to_port, rel_err, \
    to_numpy  # noqa: E402

from repro.core import peps as RP  # noqa: E402
from repro.core import sharding as RS  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core import sharding as TS  # noqa: E402
from repro_torch.core import vqe as TV  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402
from repro_torch.launch.mesh import col_mesh, make_host_mesh, make_mesh, \
    peps_mesh  # noqa: E402

TOL = 1e-10
CARDS = [torch.device("cuda", i) for i in range(8)]


def _stack(members):
    first = members[0]
    return TP.PEPS([[torch.stack([m.sites[i][j] for m in members])
                     for j in range(first.ncol)] for i in range(first.nrow)])


@pytest.mark.parametrize("ensemble,axes,spec", [
    (8, ("col", "batch"), (("col", "batch"), None)),
    (16, ("col", "batch"), (("col", "batch"), None)),
    (4, ("batch",), ("batch", None)),
    (6, ("col",), ("col", None)),
    (3, (), (None, None)),
])
def test_ensemble_sharding_rule(ensemble, axes, spec):
    mesh = peps_mesh(2, 4, devices=CARDS)
    sh = TS.ensemble_sharding(mesh, ensemble, 2)
    assert sh.axes == axes and sh.spec == spec
    assert len(sh.devices) == ensemble
    if axes == ("col", "batch"):        # chunk p on cell p, row-major
        per = ensemble // 8
        assert sh.devices == tuple(CARDS[i // per] for i in range(ensemble))
    elif axes == ("batch",):            # batch column p, col index 0
        assert sh.devices == tuple(CARDS[:4])
    elif axes == ("col",):              # col row p, batch index 0
        assert sh.devices == (CARDS[0],) * 3 + (CARDS[4],) * 3
    else:
        assert set(sh.devices) == {CARDS[0]}


def test_meshes():
    mesh = make_mesh((2, 3), ("a", "b"), devices=CARDS[:4])
    assert mesh.shape == {"a": 2, "b": 3} and mesh.size == 6
    assert list(mesh.devices.reshape(-1)) == CARDS[:4] + CARDS[:2]
    col = col_mesh(CARDS[2:5])
    assert col.shape == {"col": 3} and list(col.devices) == CARDS[2:5]
    host = make_host_mesh(devices=(CPU,))
    assert host.axis_names == ("data", "model") and host.size == 1
    sh = TS.ensemble_sharding(host, 4, 1)
    assert sh.axes == () and sh.devices == (torch.device(CPU),) * 4
    tree = {"x": torch.arange(8.0).reshape(4, 2),
            "count": torch.arange(4)}
    members = TS.shard_ensemble(tree, peps_mesh(2, 2, devices=(CPU,)), 4)
    assert [int(m["count"]) for m in members] == [0, 1, 2, 3]
    assert torch.equal(members[3]["x"], tree["x"][3])


def test_abstract_ensemble_allocates_nothing():
    cfg = TS.PEPSConfig(nrow=3, ncol=4, bond=5, ensemble=6)
    assert cfg.dtype == torch.complex64 and RS.PEPSConfig().chi == cfg.chi
    ens = TS.abstract_ensemble(cfg)
    proto = TP.random_peps(3, 4, 5, torch.Generator().manual_seed(0),
                           device=CPU)
    for row, prow in zip(ens.sites, proto.sites):
        for t, p in zip(row, prow):
            assert t.device.type == "meta" and t.dtype == torch.complex64
            assert tuple(t.shape) == (6,) + tuple(p.shape)


@pytest.fixture(scope="module")
def members():
    """Two 2x3 D=2 members in both packages, scaled as the reference's
    distributed tests scale them, and their keys."""
    refs, ports = [], []
    for seed in (0, 1):
        s = RP.random_peps(2, 3, 2, jax.random.PRNGKey(seed))
        refs.append(RP.PEPS([[t * 2.0 for t in row] for row in s.sites]))
        ports.append(ref_to_port(refs[-1]))
    rkeys = jax.random.split(jax.random.PRNGKey(9), 2)
    return refs, ports, rkeys, [JaxKey(k) for k in rkeys]


def test_batched_evolve_and_contract_match_reference(members):
    refs, ports, rkeys, tkeys = members
    mesh = peps_mesh(1, 2, devices=(CPU,))
    evolved = TS.batched_evolve(_stack(ports), tkeys, mesh=mesh)
    norms = TS.batched_contract(evolved, 4, tkeys, mesh=mesh)
    assert norms.shape == (2,)
    for i in range(2):
        want = RS.evolve_step(refs[i], rkeys[i])
        # site tensors carry each package's SVD phases: compare states
        got = TP.PEPS([[t[i] for t in row] for row in evolved.sites])
        assert rel_err(to_numpy(TP.to_statevector(got)),
                       RP.to_statevector(want)) <= TOL
        want_norm = complex(RS.contract_step(want, 4, rkeys[i]))
        assert abs(complex(norms[i]) - want_norm) <= TOL * abs(want_norm)


def test_batched_members_equal_members_alone(members):
    _, ports, _, _ = members
    keys = TorchKey(3).split(2)
    evolved = TS.batched_evolve(_stack(ports), keys)
    norms = TS.batched_contract(evolved, 4, keys)
    alone = TS.evolve_step(ports[1], keys[1])
    for row, arow in zip(evolved.sites, alone.sites):
        assert all(torch.equal(t[1], a) for t, a in zip(row, arow))
    assert torch.equal(norms[1], TS.contract_step(alone, 4, keys[1]))
    with pytest.raises(NotImplementedError, match="PEPS item 9"):
        TS.batched_contract(evolved, 4, keys, constrain_carry=lambda v: v)
    with pytest.raises(ValueError, match="3 keys for 2 members"):
        TS.batched_evolve(evolved, TorchKey(3).split(3))


def test_run_vqe_on_a_mesh_equals_the_unplaced_run():
    obs = tfi_hamiltonian(2, 2)
    kw = dict(n_layers=1, max_bond=2, maxiter=2, method="adam", ensemble=8,
              device=CPU)
    runs = [TV.run_vqe(2, 2, obs, **kw, mesh=m)
            for m in (None, peps_mesh(2, 4, devices=(CPU,)))]
    for name in ("ensemble_thetas", "ensemble_energies", "ensemble_history"):
        np.testing.assert_array_equal(getattr(runs[0], name),
                                      getattr(runs[1], name))
    assert runs[0].energy == runs[1].energy
    with pytest.raises(ValueError, match="one device type"):
        TV.run_vqe(2, 2, obs, **kw, mesh=peps_mesh(2, 4, devices=CARDS))
