"""The port's VQE (PEPS item 6) against the JAX reference, on TFI.

Energies and gradients of ``repro_torch.core.vqe`` against
``repro.core.vqe`` (one compiled reference ``value_and_grad`` per
signature, shared through module fixtures), autograd against central
finite differences and against the statevector gradient at an exact bond
budget, the degenerate product state, ``adamw_update``, and ``run_vqe``'s
optimizers on ``JaxKey`` member streams against the reference's.

Run as a script (``JAX_PLATFORMS=cpu PYTHONPATH=src python3
tests/test_torch_vqe.py``, several minutes) it measures, at the paper's
Fig. 14 setting, the reference's exact-budget gradient against its
statevector gradient and the reference's own complex64-vs-complex128 gap,
which set the bounds of ``chip_smoke.py``'s ``vqe`` phase.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_helpers import CPU, JaxKey  # noqa: E402

from repro.core import vqe as RV  # noqa: E402
from repro.core.bmps import BMPS as RBMPS  # noqa: E402
from repro.core.observable import tfi_hamiltonian as r_tfi  # noqa: E402
from repro.core.peps import QRUpdate as RQR  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro_torch.core import vqe as TV  # noqa: E402
from repro_torch.core.bmps import BMPS  # noqa: E402
from repro_torch.core.einsumsvd import RandomizedSVD  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402
from repro_torch.core.peps import QRUpdate  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

AD_FD_RTOL = 1e-4     # AD vs central FD, relative (the reference's bound)
FD_STEP = 1e-5

# (nrow, ncol, rank, chi, thetas): the reference's own test cases
# (tests/test_vqe_grad.py): the exact budget at 2x2, the degenerate product
# state and one step off it, and the truncated 3x3
GRAD_CASES = {
    "2x2_exact": (2, 2, 4, 16, np.random.default_rng(3).uniform(-0.6, 0.6, 8)),
    "2x2_theta0": (2, 2, 4, 16, np.zeros(8)),
    "2x2_theta0.01": (2, 2, 4, 16, np.full(8, 0.01)),
    "3x3_truncated": (3, 3, 2, 8,
                      np.random.default_rng(7).uniform(-0.7, 0.7, 9)),
}


def _port_grad(nrow, ncol, rank, chi, th, **kw):
    e, g = TV.vqe_energy_and_grad(th, nrow, ncol, tfi_hamiltonian(nrow, ncol),
                                  QRUpdate(rank=rank), BMPS(chi), device=CPU,
                                  **kw)
    return float(e), g.numpy()


def _sv_grad(nrow, ncol, th):
    t = torch.tensor(th, requires_grad=True)
    e = TV.vqe_energy_statevector(t, nrow, ncol, tfi_hamiltonian(nrow, ncol),
                                  device=CPU)
    (g,) = torch.autograd.grad(e, t)
    return g.numpy()


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's compiled value_and_grad of every GRAD_CASES entry."""
    out = {}
    for name, (nrow, ncol, rank, chi, th) in GRAD_CASES.items():
        e, g = RV.vqe_energy_and_grad(th, nrow, ncol, r_tfi(nrow, ncol),
                                      RQR(rank=rank), RBMPS(chi))
        out[name] = (float(e), np.asarray(g))
    return out


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_energy_and_gradient_match_reference(name, reference_grads):
    """The energy within 1e-10 and the gradient within 1e-8 of max|g|.  At
    3x3 every bond truncates, and at theta = 0 every spectrum is exactly
    degenerate: the regularized rules follow the reference there too."""
    e, g = _port_grad(*GRAD_CASES[name])
    re, rg = reference_grads[name]
    assert np.all(np.isfinite(g))
    assert abs(e - re) <= 1e-10 * max(abs(re), 1.0)
    assert np.max(np.abs(g - rg)) <= 1e-8 * np.max(np.abs(rg))
    # the energy of the value-and-grad equals the plain evaluation
    nrow, ncol, rank, chi, th = GRAD_CASES[name]
    plain = float(TV.vqe_energy_peps(th, nrow, ncol, tfi_hamiltonian(nrow, ncol),
                                     QRUpdate(rank=rank), BMPS(chi),
                                     device=CPU))
    assert abs(plain - e) <= 1e-12 * max(abs(e), 1.0)


def _fd_check(nrow, ncol, update, contract, th, grad, components):
    obs = tfi_hamiltonian(nrow, ncol)

    def f(x):
        return float(TV.vqe_energy_peps(x, nrow, ncol, obs, update, contract,
                                        device=CPU))
    for i in components:
        d = np.zeros_like(th)
        d[i] = FD_STEP
        fd = (f(th + d) - f(th - d)) / (2 * FD_STEP)
        assert abs(grad[i] - fd) <= AD_FD_RTOL * max(abs(fd), 1e-8), (i, fd)


@pytest.mark.parametrize("grid,chi,seed", [((2, 2), 6, 0), ((2, 3), 8, 1),
                                           ((2, 3), 6, 2)])
def test_grad_matches_fd_zipup(grid, chi, seed):
    nrow, ncol = grid
    n = nrow * ncol
    rng = np.random.default_rng(seed)
    th = rng.uniform(-0.7, 0.7, n)
    update, contract = QRUpdate(rank=3), BMPS(chi)
    e, g = TV.vqe_energy_and_grad(th, nrow, ncol, tfi_hamiltonian(nrow, ncol),
                                  update, contract, device=CPU)
    assert np.isfinite(float(e)) and torch.isfinite(g).all()
    _fd_check(nrow, ncol, update, contract, th, g.numpy(),
              rng.choice(n, size=2, replace=False))


def test_grad_matches_fd_randomized_svd_path():
    """RandomizedSVD: autograd runs through the whole regularized power
    iteration (the sketch is a constant of the key)."""
    svd = RandomizedSVD(niter=4, oversample=8)
    update, contract = QRUpdate(rank=3, svd=svd), BMPS(8, svd=svd)
    th = np.random.default_rng(11).uniform(-0.7, 0.7, 4)
    _, g = TV.vqe_energy_and_grad(th, 2, 2, tfi_hamiltonian(2, 2), update,
                                  contract, device=CPU)
    assert torch.isfinite(g).all()
    _fd_check(2, 2, update, contract, th, g.numpy(), [0, 2])


def test_exact_budget_gradient_is_the_statevector_gradient():
    nrow, ncol, rank, chi, th = GRAD_CASES["2x2_exact"]
    _, g = _port_grad(nrow, ncol, rank, chi, th)
    assert np.max(np.abs(g - _sv_grad(2, 2, th))) <= 1e-8


def test_degenerate_product_state():
    """theta = 0: a product state, every bond's spectrum exactly degenerate
    (the stock torch backward raises there).  The gradient is finite, and
    its components that do not grow a bond's rank ([1:4]) are the
    statevector's; one step off (theta = 0.01) all of them are."""
    _, g = _port_grad(*GRAD_CASES["2x2_theta0"])
    assert np.all(np.isfinite(g))
    assert np.max(np.abs(g - _sv_grad(2, 2, np.zeros(8)))[1:4]) <= 1e-8
    _, g = _port_grad(*GRAD_CASES["2x2_theta0.01"])
    assert np.max(np.abs(g - _sv_grad(2, 2, np.full(8, 0.01)))) <= 1e-8


# ------------------------------------------------------------------ adamw --

@pytest.mark.parametrize("moments", ["float32", "float64"])
def test_adamw_update_matches_reference(moments):
    """Four steps against the reference's jitted update: within 1e-15
    relative in float64 (VQE's moments).  In float32 XLA fuses the jitted
    update into FMAs and the last bit can differ: held at 4 float32 ulps."""
    rtol = 1e-15 if moments == "float64" else 2.0 ** -21
    rng = np.random.default_rng(9)
    shapes = {"a": (5,), "b": (2, 3)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    cfg = dict(lr=0.05, weight_decay=0.01, grad_clip=1.0)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    ts = TA.adamw_init(tp, getattr(torch, moments))
    rs = RA.adamw_init(rp, getattr(jnp, moments))
    r_update = jax.jit(RA.adamw_update, static_argnums=3)
    for _ in range(4):
        g = {k: rng.standard_normal(s) for k, s in shapes.items()}
        tp, ts, tm = TA.adamw_update({k: torch.tensor(v) for k, v in g.items()},
                                     ts, tp, TA.OptConfig(**cfg))
        rp, rs, rm = r_update({k: jnp.asarray(v) for k, v in g.items()},
                              rs, rp, RA.OptConfig(**cfg))
    for k in shapes:
        for got, want in ((tp[k], rp[k]), (ts["mu"][k], rs["mu"][k]),
                          (ts["nu"][k], rs["nu"][k])):
            want = np.asarray(want)
            assert str(got.dtype) == f"torch.{want.dtype}"
            assert np.max(np.abs(got.numpy() - want)) <= \
                rtol * np.max(np.abs(want))
    assert int(ts["count"]) == int(rs["count"]) == 4
    assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
        1e-15 * float(rm["grad_norm"])     # float64 gradients: a float64 norm


def test_global_norm_promotes_and_never_truncates():
    x = [torch.ones(3, dtype=torch.bfloat16), torch.ones(2, dtype=torch.float64)]
    assert TA.global_norm(x).dtype == torch.float64
    assert TA.global_norm([torch.ones(4, dtype=torch.bfloat16)]).dtype == \
        torch.float32


# ----------------------------------------------------------- member keys --

def test_member_streams_follow_the_reference():
    """Initial angles and SPSA signs: JaxKey reproduces the reference's
    fold_in streams exactly; TorchKey's depend only on (seed, k, i)."""
    want = np.asarray(RV._member_init(5, 3, 4))
    got = TV._member_init(JaxKey(5), 3, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    base = jax.random.fold_in(jax.random.PRNGKey(5), 0x5B5A)
    rk = jax.random.fold_in(jax.random.fold_in(base, 2), 1)
    want = np.asarray(jax.random.rademacher(rk, (6,), jnp.int32), np.float64)
    got = JaxKey(5).fold_in(0x5B5A).fold_in(2).fold_in(1).rademacher(
        (6,), torch.float64, CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    x3, x5 = TV._member_init(TorchKey(5), 3, 4), TV._member_init(TorchKey(5), 5, 4)
    assert torch.equal(x3, x5[:3]) and not torch.equal(x5[0], x5[1])
    assert x5.abs().max() < 0.1 and x5.dtype == torch.float64
    key = TorchKey(5)
    assert key.fold_in(0).seed not in {k.seed for k in key.split(4)}
    signs = key.rademacher((64,), torch.float64, CPU)
    assert set(signs.tolist()) == {-1.0, 1.0}
    assert torch.equal(signs, TorchKey(5).rademacher((64,), torch.float64, CPU))


# ---------------------------------------------------------------- run_vqe --

OBS22 = dict(nrow=2, ncol=2, n_layers=1, max_bond=2, maxiter=2, seed=0)


def _run_pair(**kw):
    ref = RV.run_vqe(OBS22["nrow"], OBS22["ncol"], r_tfi(2, 2),
                     **{k: v for k, v in OBS22.items()
                        if k not in ("nrow", "ncol")}, **kw)
    port = TV.run_vqe(OBS22["nrow"], OBS22["ncol"], tfi_hamiltonian(2, 2),
                      **{k: v for k, v in OBS22.items()
                         if k not in ("nrow", "ncol")},
                      key=JaxKey(OBS22["seed"]), device=CPU, **kw)
    return ref, port


def test_run_vqe_sequential_spsa_matches_reference():
    """The same numpy Generator stream: the trajectory to 1e-10."""
    ref, port = _run_pair(method="spsa")
    assert port.n_evals == ref.n_evals == 5
    np.testing.assert_allclose(port.history, ref.history, rtol=0, atol=1e-10)
    np.testing.assert_allclose(port.thetas, ref.thetas, rtol=0, atol=1e-10)
    assert abs(port.energy - ref.energy) <= 1e-10


@pytest.mark.parametrize("kw", [dict(method="adam", ensemble=2, lr=0.1),
                                dict(method="spsa", ensemble=2)],
                         ids=["adam", "spsa"])
def test_run_vqe_ensemble_matches_reference(kw):
    """The reference vmaps its members, the port loops over them on the
    same JaxKey streams: every member's angles and energies to 1e-10."""
    ref, port = _run_pair(**kw)
    np.testing.assert_allclose(port.ensemble_thetas, ref.ensemble_thetas,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(port.ensemble_history, ref.ensemble_history,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(port.ensemble_energies, ref.ensemble_energies,
                               rtol=0, atol=1e-10)
    assert port.n_evals == ref.n_evals == 3
    np.testing.assert_allclose(port.history, ref.history, rtol=0, atol=1e-10)
    assert np.array_equal(port.thetas,
                          port.ensemble_thetas[np.argmin(port.ensemble_energies)])


def test_run_vqe_slsqp_matches_reference():
    """scipy estimates SLSQP's gradient by forward differences with step
    1.5e-8: the 1e-14 rounding by which the two energies differ becomes a
    gradient difference of about 1e-14 / 1.5e-8 = 7e-7 a component, so the
    two runs part at that level (5.1e-7 in the final energy on the CPU).
    Held at 1e-5, 20 times that; a wrong energy or gradient is off by far
    more."""
    ref, port = _run_pair(method="SLSQP")
    assert port.n_evals == ref.n_evals
    assert abs(port.energy - ref.energy) <= 1e-5
    assert abs(port.history[0] - ref.history[0]) <= 1e-12


@pytest.mark.parametrize("method", ["SLSQP", "spsa", "adam"])
def test_run_vqe_energies_draw_from_the_callers_key_type(method, monkeypatch):
    """Every energy of a run draws its einsumsvd sketches from
    ``DEFAULT_VQE_KEY_SEED`` on the caller's key type: on a JaxKey the
    reference's ``PRNGKey(77)``, so a RandomizedSVD run replays the
    reference's sketches; without a key, ``TorchKey(77)``."""
    seen = []
    energy = TV.vqe_energy_peps

    def spy(thetas, nrow, ncol, obs, update, contract, key=None, **kw):
        seen.append(key)
        return energy(thetas, nrow, ncol, obs, update, contract, key, **kw)
    monkeypatch.setattr(TV, "vqe_energy_peps", spy)
    kw = dict(n_layers=1, max_bond=2, maxiter=1, method=method, device=CPU)
    TV.run_vqe(2, 2, tfi_hamiltonian(2, 2), key=JaxKey(3), **kw)
    want = np.asarray(jax.random.PRNGKey(RV.DEFAULT_VQE_KEY_SEED))
    assert seen and all(isinstance(k, JaxKey)
                        and np.array_equal(np.asarray(k.key), want)
                        for k in seen)
    seen.clear()
    TV.run_vqe(2, 2, tfi_hamiltonian(2, 2), **kw)
    assert seen and all(isinstance(k, TorchKey)
                        and k.seed == TV.DEFAULT_VQE_KEY_SEED for k in seen)


@pytest.mark.parametrize("method,sizes", [("adam", (1, 3)), ("spsa", (2, 3))])
def test_member_trajectory_independent_of_ensemble_size(method, sizes):
    kw = dict(n_layers=1, max_bond=2, maxiter=3, seed=1, method=method,
              device=CPU)
    small, big = (TV.run_vqe(2, 2, tfi_hamiltonian(2, 2), ensemble=k, **kw)
                  for k in sizes)
    k = sizes[0]
    assert np.array_equal(big.ensemble_thetas[:k], small.ensemble_thetas)
    assert np.array_equal(big.ensemble_history[:, :k], small.ensemble_history)


def test_lapack_qr_update_has_no_wide_derivative():
    """``QRUpdate(gram=False)`` splits wide matrices on the first gates;
    the reference raises for their derivative (``jnp.linalg.qr``), so does
    the port, where torch's would be NaN."""
    with pytest.raises(NotImplementedError, match="wide QR"):
        TV.vqe_energy_and_grad(np.full(4, 0.3), 2, 2, tfi_hamiltonian(2, 2),
                               QRUpdate(rank=2, gram=False), BMPS(4),
                               device=CPU)
    e = TV.vqe_energy_peps(np.full(4, 0.3), 2, 2, tfi_hamiltonian(2, 2),
                           QRUpdate(rank=2, gram=False), BMPS(4), device=CPU)
    assert torch.isfinite(e)


def test_not_ported_options_raise(tmp_path):
    obs = tfi_hamiltonian(2, 2)
    kw = dict(n_layers=1, max_bond=2, maxiter=1, device=CPU)
    with pytest.raises(NotImplementedError, match="PEPS item 9"):
        TV.run_vqe(2, 2, obs, **kw, mesh=object(), method="adam")
    # the runtime guard and checkpoint/resume are ported (PEPS item 7)
    res = TV.run_vqe(2, 2, obs, **kw, method="spsa", guard=True,
                     checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert res.guard is not None and res.guard.events == []
    assert res.resumed_from is None and (tmp_path / "step_00000001").is_dir()
    g = TV.runtime_guard.RuntimeGuard()
    e, grad = TV.vqe_energy_and_grad(np.zeros(4), 2, 2, obs,
                                     QRUpdate(rank=2), BMPS(4), guard=g,
                                     device=CPU)
    assert torch.isfinite(e) and bool(torch.isfinite(grad).all())
    assert g.report.events == []
    with pytest.raises(ValueError, match="batched driver"):
        TV.run_vqe(2, 2, obs, **kw, method="SLSQP", ensemble=4)


# ---------------------- the reference at chip_smoke.py's vqe-phase setting --

# The vqe phase's angles: numpy seed 1234 + 2 (chip_smoke.py's SEED + 2)
VQE_PHASE_SEED = 1236


def _fig14_angles(seed):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, 18)


def reference_exact_budget_gap(seed=VQE_PHASE_SEED):
    """The reference's complex128 gradient at ``QRUpdate(rank=4)``,
    ``BMPS(8)`` (exact at 3x3) against ``jax.grad`` of its statevector
    energy, at the paper's Fig. 14 setting, with the port's beside it.  What
    is left is the regularizer's own bias (the Lorentzian broadening of a
    near-degenerate singular pair), which sets the vqe phase's
    ``VQE_SV_GRAD_TOL``."""
    nrow = ncol = 3
    th = _fig14_angles(seed)
    r_obs = r_tfi(nrow, ncol, jz=-1.0, hx=-3.5)
    e, g = RV.vqe_energy_and_grad(th, nrow, ncol, r_obs, RQR(rank=4),
                                  RBMPS(8))
    esv, gsv = jax.value_and_grad(
        lambda t: RV.vqe_energy_statevector(t, nrow, ncol, r_obs))(
            jnp.asarray(th))
    obs = tfi_hamiltonian(nrow, ncol, jz=-1.0, hx=-3.5)
    pe, pg = TV.vqe_energy_and_grad(th, nrow, ncol, obs, QRUpdate(rank=4),
                                    BMPS(8), device=CPU)
    t = torch.tensor(th, requires_grad=True)
    (psv,) = torch.autograd.grad(
        TV.vqe_energy_statevector(t, nrow, ncol, obs, device=CPU), t)
    g, gsv, pg, psv = (np.asarray(x) for x in (g, gsv, pg, psv))
    return {"seed": seed, "rank": 4, "chi": 8,
            "reference": {"energy_vs_statevector": abs(float(e) - float(esv)),
                          "grad_max_abs_vs_statevector":
                              float(np.max(np.abs(g - gsv)))},
            "port": {"energy_vs_statevector": abs(float(pe) - float(esv)),
                     "grad_max_abs_vs_statevector":
                         float(np.max(np.abs(pg - psv)))},
            "port_vs_reference_grad_max_abs": float(np.max(np.abs(pg - g)))}


def reference_c64_gap(seeds=(0, 1, VQE_PHASE_SEED)):
    """The reference's complex64 VQE energy and gradient against its
    complex128 ones at the paper's Fig. 14 setting (3x3 TFI, jz = -1,
    hx = -3.5, 2 layers), at ``QRUpdate(rank=4)``, ``BMPS(8)`` (exact at
    3x3) and ``QRUpdate(rank=2)``, ``BMPS(4)``; angles uniform in
    [-pi, pi) from ``seeds`` (the last is the vqe phase's).  Energies
    relative, gradients relative to max|g|.  A property of the reference,
    not of the port; the eager gradients take minutes."""
    from repro.core import peps as RP
    from repro.core.circuits import apply_circuit_peps, vqe_ansatz
    from repro.core.expectation import expectation

    obs = r_tfi(3, 3, jz=-1.0, hx=-3.5)
    dtypes = {"complex128": jnp.complex128, "complex64": jnp.complex64}

    def energy(th, dtype, update, contract):
        state = apply_circuit_peps(
            RP.computational_zeros(3, 3, dtype=dtype), vqe_ansatz(3, 3, th),
            update, jax.random.PRNGKey(RV.DEFAULT_VQE_KEY_SEED))
        return jnp.real(expectation(state, obs, contract, use_cache=True))

    lines = []
    for rank, chi in ((4, 8), (2, 4)):
        update, contract = RP.QRUpdate(rank=rank), RBMPS(chi)
        for seed in seeds:
            th = _fig14_angles(seed)
            e = {k: float(energy(th, dt, update, contract))
                 for k, dt in dtypes.items()}
            g = {k: np.asarray(jax.grad(
                lambda t, dt=dt: energy(t, dt, update, contract))(
                    jnp.asarray(th))) for k, dt in dtypes.items()}
            lines.append({
                "rank": rank, "chi": chi, "seed": seed, "energy": e,
                "energy_c64_vs_c128": abs(e["complex64"] - e["complex128"])
                / abs(e["complex128"]),
                "grad_c64_vs_c128": float(
                    np.max(np.abs(g["complex64"] - g["complex128"]))
                    / np.max(np.abs(g["complex128"])))})
    return lines


if __name__ == "__main__":
    import json
    print(json.dumps(reference_exact_budget_gap()), flush=True)
    for line in reference_c64_gap():
        print(json.dumps(line), flush=True)
