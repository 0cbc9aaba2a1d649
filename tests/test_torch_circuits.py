"""The port's statevector oracle and circuits against the JAX reference.

The same circuits (built from the same seed, which both packages draw from
``np.random.default_rng``) and the same states (carried across as numpy)
go through both packages in complex128: the statevector functions agree to
1e-12, the RQC gate lists exactly, exact PEPS evolution matches the
statevector to 1e-12, and truncated PEPS evolution on JAX-backed keys
gives the reference's amplitudes to 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_helpers import CPU, JaxKey, ref_to_port, rel_err, to_numpy, \
    to_torch  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import circuits as RC  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core import statevector as RSV  # noqa: E402
from repro.core.einsumsvd import RandomizedSVD as RRand  # noqa: E402
from repro.core.observable import j1j2_hamiltonian as r_j1j2  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.core import circuits as TC  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core import statevector as TSV  # noqa: E402
from repro_torch.core.einsumsvd import RandomizedSVD as TRand  # noqa: E402
from repro_torch.core.observable import j1j2_hamiltonian as t_j1j2  # noqa: E402


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2,) * n)
            + 1j * rng.standard_normal((2,) * n)).astype(np.complex128)


def test_statevector_functions_match_reference():
    psi = _random_state(6, 0)
    phi = _random_state(6, 1)
    r, t = jnp.asarray(psi), to_torch(psi)
    assert TSV.zeros(4, device=CPU).dtype == torch.complex128
    np.testing.assert_array_equal(to_numpy(TSV.zeros(4, device=CPU)),
                                  np.asarray(RSV.zeros(4)))
    for g, sites in [(RC.G.SQRT_W, [4]), (RC.G.ISWAP, [1, 5]),
                     (RC.G.CX, [3, 0])]:
        assert rel_err(to_numpy(TSV.apply_gate(t, g, sites)),
                       RSV.apply_gate(r, g, sites)) <= 1e-12
    bits = [1, 0, 1, 1, 0, 0]
    assert TSV.amplitude(t, bits).item() == complex(RSV.amplitude(r, bits))
    assert rel_err(to_numpy(TSV.inner(t, to_torch(phi))),
                   RSV.inner(r, jnp.asarray(phi))) <= 1e-12
    assert abs(TSV.norm(t).item() - float(RSV.norm(r))) <= 1e-12 * float(RSV.norm(r))
    assert rel_err(to_numpy(TSV.normalize(t)), RSV.normalize(r)) <= 1e-12
    terms = r_j1j2(2, 3).as_tuples()
    assert rel_err(to_numpy(TSV.expectation(t, t_j1j2(2, 3).as_tuples())),
                   RSV.expectation(r, terms)) <= 1e-12
    with pytest.raises(ValueError, match="arity"):
        TSV.apply_gate(t, np.eye(8), [0, 1, 2])


@pytest.mark.parametrize("args", [(2, 3, 8, 0), (3, 3, 5, 7, 2)])
def test_random_circuit_gate_lists_equal_reference(args):
    want = RC.random_circuit(*args)
    got = TC.random_circuit(*args)
    assert len(got) == len(want) > 0
    for (g, s), (rg, rs) in zip(got, want):
        assert s == rs
        np.testing.assert_array_equal(g, rg)


def test_vqe_ansatz_numpy_and_torch_angles():
    thetas = np.random.default_rng(3).uniform(0, np.pi, 2 * 4)
    want = RC.vqe_ansatz(2, 2, thetas)
    got = TC.vqe_ansatz(2, 2, thetas)
    assert [s for _, s in got] == [s for _, s in want]
    for (g, _), (rg, _) in zip(got, want):
        np.testing.assert_array_equal(g, rg)
    # torch angles: the same gates, the reference's energy, and autograd
    # through the angles agrees with central differences
    obs_t = t_j1j2(2, 2).as_tuples()

    def energy(th):
        vec = TC.apply_circuit_statevector(TSV.zeros(4, device=CPU),
                                           TC.vqe_ansatz(2, 2, th))
        return TSV.expectation(vec, obs_t).real

    th = torch.tensor(thetas, dtype=torch.float64, requires_grad=True)
    for (g, _), (rg, _) in zip(TC.vqe_ansatz(2, 2, th), want):
        g = to_numpy(g) if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, rg, atol=1e-15)
    e = energy(th)
    e.backward()
    vec = RC.apply_circuit_statevector(RSV.zeros(4), want)
    want_e = float(jnp.real(RSV.expectation(vec, r_j1j2(2, 2).as_tuples())))
    assert abs(e.item() - want_e) <= 1e-12 * abs(want_e)
    h = 1e-6
    with torch.no_grad():
        fd = [(energy(th + h * d) - energy(th - h * d)).item() / (2 * h)
              for d in torch.eye(len(thetas), dtype=torch.float64)]
    assert rel_err(to_numpy(th.grad), fd) <= 1e-8
    with pytest.raises(ValueError, match="multiple"):
        TC.vqe_ansatz(2, 2, thetas[:3])


def test_exact_evolution_matches_statevector():
    circuit = RC.random_circuit(2, 3, 8, seed=4)
    want = RC.apply_circuit_statevector(RSV.zeros(6), circuit)
    vec = TC.apply_circuit_statevector(TSV.zeros(6, device=CPU), circuit)
    assert rel_err(to_numpy(vec), want) <= 1e-12
    state = TC.apply_circuit_exact_peps(TP.computational_zeros(2, 3, device=CPU),
                                        circuit)
    assert state.max_bond() == 16           # two iSWAP rounds, 4 x 4
    assert rel_err(to_numpy(TP.to_statevector(state)), want) <= 1e-12
    with pytest.raises(ValueError, match="adjacent"):
        TC.apply_circuit_exact_peps(TP.computational_zeros(2, 3, device=CPU),
                                    [(RC.G.ISWAP, [0, 4])])


def test_truncated_circuit_amplitudes_match_reference_on_jax_keys():
    """RQC with the QR update at rank 2 and a randomized seed split, so
    every gate draws from its key: the port on JAX-backed keys follows the
    reference's truncations, and the amplitudes agree.  The sites split
    with LAPACK QR (``gram=False``): the Gram-QR of an edge site clamps
    exact-zero eigenvalues, and the noise columns that gives (relative size
    sqrt(1e-13), different under each LAPACK) are mixed in by the sketch
    (see ``test_torch_parity.test_qr_update_gate_application_statevector``)."""
    circuit = RC.random_circuit(2, 3, 4, seed=5)
    rupd = RP.QRUpdate(rank=2, svd=RRand(niter=2, oversample=2, fused=False),
                       gram=False)
    tupd = TP.QRUpdate(rank=2, svd=TRand(niter=2, oversample=2, fused=False),
                       gram=False)
    ref = RC.apply_circuit_peps(RP.computational_zeros(2, 3), circuit, rupd,
                                key=jax.random.PRNGKey(8))
    got = TC.apply_circuit_peps(TP.computational_zeros(2, 3, device=CPU),
                                circuit, tupd, key=JaxKey(8))
    assert got.max_bond() == 2
    assert rel_err(to_numpy(TP.to_statevector(got)),
                   RP.to_statevector(ref)) <= 1e-10      # every amplitude
    bits = [1, 0, 1, 0, 1, 1]
    assert rel_err(to_numpy(TB.amplitude(got, bits, TB.BMPS(8))),
                   RB.amplitude(ref, bits, RB.BMPS(8))) <= 1e-10
    # the default key is the reference's seed, 123, in the port's own stream
    a = TC.apply_circuit_peps(ref_to_port(RP.computational_zeros(2, 3)),
                              circuit[:7], tupd)
    b = TC.apply_circuit_peps(ref_to_port(RP.computational_zeros(2, 3)),
                              circuit[:7], tupd, key=TC.TorchKey(123))
    for ta, tb in zip(a.sites[0], b.sites[0]):
        assert torch.equal(ta, tb)
