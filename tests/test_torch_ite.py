"""The port's imaginary time evolution against the JAX reference, c128.

The same inputs (reference constructors from a seed, carried across as
numpy, row environments through ``convert.envs_from_numpy``) go through both
packages: strip boundaries, bond environments, the positive fix and the ALS
bond optimization agree to 1e-10, a full-update gate to 1e-10 as a
statevector (gauge-free), and ``ite_run`` with the QR and the full update on
JAX-backed keys to 1e-8 in energies and fidelities, with the same fused-cache
counts.  Then the port's own behaviour: shape-stale environments, the
product-state fidelity, the planner cache after the bonds stop growing, the
options it refuses, and the double-precision retry of a failed eigh.

Run as a script, the module measures how far the reference's own
complex64 ITE lies from its complex128 run, on the CPU (about five
minutes; it sets the complex64 bounds of ``chip_smoke.py``'s ``ite``
phase):

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tests/test_torch_ite.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import CPU, JaxKey, ref_to_port, rel_err, to_numpy, \
    to_torch  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import full_update as RFU  # noqa: E402
from repro.core import gates as RG  # noqa: E402
from repro.core import ite as RI  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core import planner as RPL  # noqa: E402
from repro.core.einsumsvd import RandomizedSVD as RRand, \
    einsumsvd as r_einsumsvd  # noqa: E402
from repro.core.environments import row_environments as r_row_envs, \
    strip_boundary as r_strip  # noqa: E402
from repro.core.expectation import expectation_trotter as r_trotter  # noqa: E402
from repro.core.observable import tfi_hamiltonian as r_tfi  # noqa: E402
from repro_torch.convert import envs_from_numpy, envs_to_numpy  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.core import full_update as TFU  # noqa: E402
from repro_torch.core import ite as TI  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core import planner as TPL  # noqa: E402
from repro_torch.core import svd_grad  # noqa: E402
from repro_torch.core.einsumsvd import RandomizedSVD as TRand  # noqa: E402
from repro_torch.core.environments import row_environments, \
    strip_boundary  # noqa: E402
from repro_torch.core.expectation import expectation_trotter  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402

TOL = 1e-10


@pytest.fixture(scope="module")
def envs_2x3():
    """A random 2x3 D=2 PEPS and the reference's row environments, in both
    packages."""
    ref = RP.random_peps(2, 3, 2, jax.random.PRNGKey(0))
    envs = r_row_envs(ref, RB.BMPS(8), jax.random.PRNGKey(1))
    numpy_envs = tuple([[np.asarray(t) for t in lvl] for lvl in side]
                       for side in envs)
    port_envs = envs_from_numpy(numpy_envs, device=CPU)
    return ref, envs, ref_to_port(ref), port_envs


def test_envs_cross_as_numpy(envs_2x3):
    _, envs, _, port_envs = envs_2x3
    back = envs_to_numpy(port_envs)
    assert [len(side) for side in back] == [len(side) for side in envs] == [3, 2]
    for side, rside in zip(back, envs):
        for lvl, rlvl in zip(side, rside):
            for t, rt in zip(lvl, rlvl):
                np.testing.assert_array_equal(t, np.asarray(rt))


@pytest.mark.parametrize("rows,cut", [((0,), 0), ((1,), 1), ((0,), 3),
                                      ((0, 1), 1), ((0, 1), 2)])
def test_strip_boundary_matches_reference(envs_2x3, rows, cut):
    ref, (rtop, rbot), port, (top, bot) = envs_2x3
    i0, i1 = rows[0], rows[-1]
    rrows = [ref.sites[i] for i in rows]
    trows = [port.sites[i] for i in rows]
    for from_left in (True, False):
        want = r_strip(rtop[i0], rbot[i1], rrows, rrows, cut, from_left)
        got = strip_boundary(top[i0], bot[i1], trows, trows, cut, from_left)
        assert got.shape == want.shape
        assert rel_err(to_numpy(got), want) <= TOL


_SPLITS = {"horizontal": ((1, 0), (1, 1), (1, 2, 3, 0, 4), (1, 3, 4, 0, 2)),
           "vertical": ((0, 1), (1, 1), (1, 2, 4, 0, 3), (2, 3, 4, 0, 1))}


def _bond_inputs(envs_2x3, orient):
    """The reference's reduced split of a bond, both packages' copies."""
    ref, envs, port, port_envs = envs_2x3
    s0, s1, axes_a, axes_b = _SPLITS[orient]
    qa, ra = RFU._reduced_split(ref.sites[s0[0]][s0[1]], axes_a)
    qb, rb = RFU._reduced_split(ref.sites[s1[0]][s1[1]], axes_b)
    return s0, s1, (qa, ra, qb, rb), [to_torch(np.asarray(x))
                                      for x in (qa, ra, qb, rb)]


@pytest.mark.parametrize("orient", ["horizontal", "vertical"])
def test_bond_environment_positive_fix_and_als_match_reference(envs_2x3,
                                                               orient):
    ref, envs, port, port_envs = envs_2x3
    s0, s1, (qa, ra, qb, rb), (tqa, tra, tqb, trb) = _bond_inputs(envs_2x3,
                                                                  orient)
    env = RFU.bond_environment(ref, s0, s1, qa, qb, envs)
    tenv = TFU.bond_environment(port, s0, s1, tqa, tqb, port_envs)
    assert tenv.shape == env.shape and rel_err(to_numpy(tenv), env) <= TOL
    assert rel_err(to_numpy(TFU.positive_fix(tenv)),
                   RFU.positive_fix(env)) <= TOL
    # the ALS from the same seed: the pair product and the fidelity
    g = RG.trotter_gate(RG.pauli_term("ZZ") - 0.5 * RG.pauli_term("XX"), 0.3)
    theta = RPL.cached_einsum("xypq,abpk,cdqk->abxycd", g, ra, rb)
    left, right = r_einsumsvd(RP.DirectSVD(), [g, ra, rb],
                              ["xypq", "abpk", "cdqk"], row="xab", col="ycd",
                              rank=2, absorb="both")
    a0, b0 = np.moveaxis(np.asarray(left), 0, 2), np.asarray(right)
    kw = dict(n_iter=6, eps=1e-12, positive=True)
    ra_, rb_, rfid = RFU._optimize_bond(env, theta, a0, b0, **kw)
    ta, tb, tfid = TFU._optimize_bond(tenv, to_torch(np.asarray(theta)),
                                      to_torch(a0), to_torch(b0), **kw)
    # the pair products agree in the metric the ALS minimizes in: E has
    # (near-)null directions, fixed only by the 1e-12 regularizer, where
    # both solutions carry amplified rounding and neither affects the state
    fixed = TFU.positive_fix(tenv)
    diff = TFU._pair(ta, tb) - to_torch(np.asarray(RFU._pair(ra_, rb_)))
    ab = TFU._pair(ta, tb)
    gap = TFU._env_overlap(fixed, diff, diff).real / TFU._env_overlap(
        fixed, ab, ab).real
    assert gap.item() ** 0.5 <= TOL
    assert abs(tfid.item() - float(rfid)) <= TOL
    assert 0.5 < tfid.item() <= 1.0 + 1e-9


@pytest.mark.parametrize("sites", [[0, 1], [4, 1]])
def test_full_update_gate_matches_reference(envs_2x3, sites):
    """One full-update gate on a 2x3 D=2 state with DirectSVD seeds, on the
    same cached environments: the same state (compared as statevectors)
    and the same bond fidelity."""
    ref, envs, _, port_envs = envs_2x3
    upd = dict(rank=2, chi=8)
    g = RG.trotter_gate(-1.0 * RG.pauli_term("ZZ") + 0.3 * RG.pauli_term("XY"),
                        0.2)
    RFU.drain_fidelities()
    TFU.drain_fidelities()
    want = RP.apply_operator(ref, g, sites, RP.FullUpdate(**upd),
                             key=jax.random.PRNGKey(4), envs=envs)
    got = TP.apply_operator(ref_to_port(ref), g, sites, TP.FullUpdate(**upd),
                            key=JaxKey(4), envs=port_envs)
    assert rel_err(to_numpy(TP.to_statevector(got)),
                   RP.to_statevector(want)) <= TOL
    (rfid,), (tfid,) = RFU.drain_fidelities(), TFU.drain_fidelities()
    assert abs(tfid - rfid) <= TOL and 0.9 < tfid <= 1.0 + 1e-9


def test_expectation_trotter_matches_reference():
    ref = RP.random_peps(2, 2, 2, jax.random.PRNGKey(5))
    want = r_trotter(ref, r_tfi(2, 2), RB.BMPS(8), tau=1e-2,
                     key=jax.random.PRNGKey(6))
    got = expectation_trotter(ref_to_port(ref), tfi_hamiltonian(2, 2),
                              TB.BMPS(8), tau=1e-2, key=JaxKey(6))
    assert rel_err(to_numpy(got), want) <= TOL
    # key=None is the reference's seed, 21, in the port's own stream
    default = expectation_trotter(ref_to_port(ref), tfi_hamiltonian(2, 2),
                                  TB.BMPS(8), tau=1e-2)
    assert rel_err(to_numpy(default), want) <= TOL   # DirectSVD: no sketch


def _updates(kind, randomized):
    svd_r = RRand(niter=2, oversample=2, fused=False) if randomized \
        else RP.DirectSVD()
    svd_t = TRand(niter=2, oversample=2, fused=False) if randomized \
        else TP.DirectSVD()
    if kind == "qr":
        return RP.QRUpdate(rank=2, svd=svd_r), TP.QRUpdate(rank=2, svd=svd_t)
    return (RP.FullUpdate(rank=2, chi=8, svd=svd_r),
            TP.FullUpdate(rank=2, chi=8, svd=svd_t))


@pytest.mark.parametrize("grid,kind,randomized", [
    ((2, 2), "qr", False), ((2, 3), "full", True)])
def test_ite_run_matches_reference(grid, kind, randomized):
    """Three steps measured after two and three, on JAX-backed keys (the
    2x3 run seeds each split with a randomized SVD, so every gate draws its
    sketch; test_torch_circuits does the same for the QR update)."""
    rupd, tupd = _updates(kind, randomized)
    RPL.clear()
    TPL.clear()
    want = RI.ite_run(RP.computational_zeros(*grid), r_tfi(*grid), 0.05, 3,
                      rupd, RB.BMPS(8), measure_every=2,
                      key=jax.random.PRNGKey(7))
    got = TI.ite_run(TP.computational_zeros(*grid, device=CPU),
                     tfi_hamiltonian(*grid), 0.05, 3, tupd, TB.BMPS(8),
                     measure_every=2, key=JaxKey(7))
    assert got.steps == want.steps == [2, 3]
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-8)
    if kind == "full":
        np.testing.assert_allclose(got.fidelities, want.fidelities, rtol=1e-8)
    else:
        assert got.fidelities is want.fidelities is None
    assert got.guard is None and got.resumed_from is None
    # the same lookups of the same caches; the reference counts a path
    # lookup inside its jitted ALS only while tracing, the port every call
    for k in ("fused_hits", "fused_misses", "path_misses"):
        assert got.planner_stats[k] == want.planner_stats[k], k
    assert got.planner_stats["path_hits"] >= want.planner_stats["path_hits"]


def test_ite_statevector_matches_reference():
    vec, e = TI.ite_statevector(2, 3, tfi_hamiltonian(2, 3), 0.05, 10,
                                device=CPU)
    rvec, re = RI.ite_statevector(2, 3, r_tfi(2, 3), 0.05, 10)
    assert rel_err(to_numpy(vec), rvec) <= 1e-12
    assert abs(e - re) <= 1e-12 * abs(re)
    moments = TI.trotter_moments(tfi_hamiltonian(2, 3), 0.05)
    assert [s for _, s in moments] == [s for _, s in
                                       RI.trotter_moments(r_tfi(2, 3), 0.05)]


def test_ite_from_the_neel_state_matches_reference():
    """2x2 J1-J2 (diagonal terms, so SWAP chains) from the Neel state, the
    chip smoke's J1-J2 start: the statevector ITE with ``bits=`` against
    the reference's evolution of the same basis state at 1e-12, and the QR
    update from ``computational_basis`` on JAX-backed keys at 1e-8."""
    from repro.core import statevector as RSV
    from repro.core.observable import j1j2_hamiltonian as r_j1j2
    from repro_torch.core.observable import j1j2_hamiltonian
    neel = np.indices((2, 2)).sum(axis=0) % 2
    vec, e = TI.ite_statevector(2, 2, j1j2_hamiltonian(2, 2), 0.05, 2,
                                device=CPU, bits=neel)
    rvec = RSV.zeros(4)
    for s in np.flatnonzero(neel):
        rvec = RSV.apply_gate(rvec, RG.gate("X"), [int(s)])
    for _ in range(2):
        for g, sites in RI.trotter_moments(r_j1j2(2, 2), 0.05):
            rvec = RSV.apply_gate(rvec, g, sites)
        rvec = RSV.normalize(rvec)
    re = float(RSV.expectation(rvec, r_j1j2(2, 2).as_tuples()).real)
    assert rel_err(to_numpy(vec), rvec) <= 1e-12
    assert abs(e - re) <= 1e-12 * abs(re)
    want = RI.ite_run(RP.computational_basis(neel), r_j1j2(2, 2), 0.05, 2,
                      RP.QRUpdate(rank=2), RB.BMPS(8),
                      key=jax.random.PRNGKey(3))
    got = TI.ite_run(TP.computational_basis(neel, device=CPU),
                     j1j2_hamiltonian(2, 2), 0.05, 2, TP.QRUpdate(rank=2),
                     TB.BMPS(8), key=JaxKey(3))
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-8)
    # the rank-2 truncation moves the energy by 1.3e-2 of the exact ITE's
    assert abs(got.energies[-1] - re) <= 5e-2 * abs(re)


# ------------------------------------------------------- port behaviour ----

def test_stale_envs_detected_and_refreshed():
    """Environments cached before a bond grew are shape-stale and are
    recomputed by full_update_bond."""
    state = TP.computational_zeros(2, 2, device=CPU)
    upd = TP.FullUpdate(rank=2, chi=8)
    envs = row_environments(state, TFU.env_option(upd), TP.TorchKey(0))
    assert TFU.envs_compatible(state, (1, 0), (1, 1), envs)
    grown = TP.apply_operator(state, RG.CX, [0, 2], TP.QRUpdate(rank=2))
    assert not TFU.envs_compatible(grown, (1, 0), (1, 1), envs)
    TFU.drain_fidelities()
    out = TFU.full_update_bond(grown, RG.CX, (1, 0), (1, 1), upd,
                               TP.TorchKey(1), envs=envs)
    fids = TFU.drain_fidelities()
    assert out.sites[1][0].shape[4] == 2
    assert len(fids) == 1 and 0.99 <= fids[0] <= 1.0 + 1e-9


def test_product_state_fidelity_is_one_and_the_log_drains():
    TFU.drain_fidelities()
    state = TP.computational_zeros(2, 2, device=CPU)
    hh = np.kron(RG.H, RG.H).reshape(2, 2, 2, 2)
    TP.apply_operator(state, hh, [0, 1], TP.FullUpdate(rank=2, chi=8))
    assert len(TFU.pending_fidelities()) == 1      # pending does not clear
    fids = TFU.drain_fidelities()
    assert len(fids) == 1 and isinstance(fids[0], float)
    assert abs(fids[0] - 1.0) < 1e-8
    assert TFU.drain_fidelities() == []


def test_planner_caches_hold_once_the_bonds_stop_growing():
    obs = tfi_hamiltonian(2, 2)
    upd = TP.FullUpdate(rank=2, chi=8)
    kw = dict(tau=0.05, contract=TB.BMPS(8), measure_every=100)
    warm = TI.ite_run(TP.computational_zeros(2, 2, device=CPU), obs, steps=2,
                      update=upd, **kw)
    res = TI.ite_run(warm.state, obs, steps=3, update=upd, **kw)
    assert res.planner_stats["path_misses"] == 0
    assert res.planner_stats["fused_misses"] == 0
    assert res.planner_stats["fused_hits"] > 0
    assert all(0.9 <= f <= 1.0 + 1e-9 for f in res.fidelities)


def test_unported_and_unknown_options_raise(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class BogusUpdate:
        rank: int = 2

    state = TP.computational_zeros(2, 2, device=CPU)
    obs = tfi_hamiltonian(2, 2)
    with pytest.raises(TypeError, match="BogusUpdate"):
        TP.check_update(BogusUpdate())
    with pytest.raises(TypeError, match="BogusUpdate"):
        TI.ite_run(state, obs, 0.05, 1, BogusUpdate(), TB.BMPS(4))
    # the runtime guard and checkpoint/resume are ported (PEPS item 7)
    res = TI.ite_run(state, obs, 0.05, 1, TP.QRUpdate(rank=2), TB.BMPS(4),
                     guard=True)
    assert res.guard is not None and res.guard.events == []
    res = TI.ite_run(state, obs, 0.05, 1, TP.QRUpdate(rank=2), TB.BMPS(4),
                     checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert res.resumed_from is None and (tmp_path / "step_00000001").is_dir()
    with pytest.raises(NotImplementedError, match="PEPS item 9"):
        TP.FullUpdate(rank=2, env_contract="distributed")
    upd = TP.FullUpdate(rank=2, env_contract=TB.BMPS(6))
    assert TFU.env_option(upd) == TB.BMPS(6)
    assert TFU.env_option(TP.FullUpdate(rank=2, chi=5)) == TB.BMPS(5)


@pytest.mark.parametrize("nan_in", ["w", "v"])
def test_eigh_reg_retries_a_failed_single_precision_solve(monkeypatch,
                                                          nan_in):
    """A complex64 eigh that raises, or returns NaN in its eigenvalues or
    its eigenvectors, is computed once more in complex128; complex128 is
    never retried."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    a = torch.from_numpy(m @ m.conj().T).to(torch.complex64)
    real_eigh = torch.linalg.eigh

    def failing(x):
        if x.dtype == torch.complex64:
            w, v = real_eigh(x)
            if nan_in == "w":
                return torch.full_like(w, float("nan")), v
            return w, torch.full_like(v, complex("nan"))
        return real_eigh(x)

    monkeypatch.setattr(torch.linalg, "eigh", failing)
    before = svd_grad.eigh_reg.widened
    w, v = svd_grad.eigh_reg(a)
    assert svd_grad.eigh_reg.widened == before + 1
    assert w.dtype == torch.float32 and v.dtype == torch.complex64
    want = np.linalg.eigvalsh(a.numpy().astype(np.complex128))
    assert np.allclose(w.numpy(), want, rtol=1e-5)

    def raising(x):
        raise torch.linalg.LinAlgError("failed to converge")

    monkeypatch.setattr(torch.linalg, "eigh", raising)
    with pytest.raises(torch.linalg.LinAlgError):
        svd_grad.eigh_reg(a.to(torch.complex128))
    assert svd_grad.eigh_reg.widened == before + 1


# ------------------------------------------- the reference's c64 ITE gap ----

def reference_c64_gap():
    """The reference's complex64 ITE against its complex128 run, one dict
    per measurement (a property of the reference, not of the port):

    * ``tfi_fu``: the 2x3 TFI full update (``FullUpdate(rank=2, chi=8)``,
      30 steps) at the reference's ``als_eps`` = 1e-12, where the
      regulariser lies below complex64 rounding and the energies are NaN,
      and at 1e-6;
    * ``j1j2_qr``: 4x4 J1-J2, ``QRUpdate(rank=4)``, energy at ``BMPS(16,
      RandomizedSVD(niter=2, oversample=4))`` after 20 steps, the ``ite``
      phase's configuration, from |0...0> and from the Neel state.  From
      |0...0>, a near-eigenstate that only the 0.2 fields move, the
      evolution departs at a rate that rounding and the Gram-QR clamp
      seed, so the two precisions part; from the Neel state they agree."""
    import jax.numpy as jnp
    dtypes = {"complex128": jnp.complex128, "complex64": jnp.complex64}

    def energies(grid, obs, update, contract, steps, bits=None):
        bits = np.zeros(grid, dtype=int) if bits is None else bits
        return {name: RI.ite_run(RP.computational_basis(bits, dtype=dt), obs,
                                 0.05, steps, update, contract,
                                 measure_every=10).energies
                for name, dt in dtypes.items()}

    def gap(run):
        lo, hi = run["complex64"][-1], run["complex128"][-1]
        return abs(lo - hi) / abs(hi)

    tfi = {"what": "tfi_fu", "grid": "2x3", "steps": 30}
    for eps in (1e-12, 1e-6):
        run = energies((2, 3), r_tfi(2, 3), RP.FullUpdate(rank=2, chi=8,
                                                          als_eps=eps),
                       RB.BMPS(8), 30)
        tfi[f"als_eps={eps:g}"] = {**run, "c64_vs_c128": gap(run)}
    from repro.core.observable import j1j2_hamiltonian
    j1j2 = {"what": "j1j2_qr", "grid": "4x4", "steps": 20}
    for start, bits in (("zeros", None),
                        ("neel", np.indices((4, 4)).sum(axis=0) % 2)):
        run = energies((4, 4), j1j2_hamiltonian(4, 4), RP.QRUpdate(rank=4),
                       RB.BMPS(16, RRand(niter=2, oversample=4)), 20, bits)
        j1j2[start] = {**run, "c64_vs_c128": gap(run)}
    return [tfi, j1j2]


if __name__ == "__main__":
    import json
    for line in reference_c64_gap():
        print(json.dumps(line), flush=True)
