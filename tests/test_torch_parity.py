"""End-to-end parity of the port's main path with the JAX reference, c128.

The same inputs (made with the reference's constructors from a seed, carried
across as numpy) go through both packages: the one-layer contraction, the
two-layer norm, QR-update gate application (as statevectors) and the
expectation with and without cached environments.  ``DirectSVD`` agrees to
1e-12 relative; ``RandomizedSVD`` runs on JAX-backed keys (both packages draw
the same sketches) and agrees to 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import JaxKey, ref_to_port, rel_err, rows_to_torch, \
    to_numpy  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import expectation as RE  # noqa: E402
from repro.core import gates as RG  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core.observable import Observable as RObs  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.core import expectation as TE  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core.observable import Observable as TObs  # noqa: E402

TOL = {"direct": 1e-12, "randomized": 1e-10}


def _options(kind, chi):
    if kind == "direct":
        return RB.BMPS(chi), TB.BMPS(chi)
    # the reference runs unfused (no per-signature jit compile); both
    # compute the same arithmetic
    return (RB.BMPS.randomized(chi, niter=2, oversample=4, fused=False),
            TB.BMPS.randomized(chi, niter=2, oversample=4))


def _keys(seed):
    return jax.random.PRNGKey(seed), JaxKey(seed)


@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_contract_onelayer_4x4(kind):
    rows = RP.random_onelayer(4, 4, 3, jax.random.PRNGKey(42))
    ropt, topt = _options(kind, 8)
    rk, tk = _keys(17)
    want = RB.contract_onelayer(rows, ropt, key=rk)
    got = TB.contract_onelayer(rows_to_torch(rows), topt, key=tk)
    assert rel_err(to_numpy(got), want) <= TOL[kind]


@pytest.mark.parametrize("kind", ["direct", "randomized"])
def test_norm_squared_3x3_twolayer(kind):
    state = RP.random_peps(3, 3, 2, jax.random.PRNGKey(7))
    ropt, topt = _options(kind, 4)
    rk, tk = _keys(3)
    want = RB.norm_squared(state, ropt, key=rk)
    got = TB.norm_squared(ref_to_port(state), topt, key=tk)
    assert rel_err(to_numpy(got), want) <= TOL[kind]


# (gate name, sites): adjacent, reversed, vertical, non-adjacent (SWAP chain)
_CIRCUIT = [("H", [0]), ("RY", [4]), ("CX", [0, 1]), ("CX", [2, 1]),
            ("CZ", [1, 4]), ("ISWAP", [5, 2]), ("CX", [0, 5]), ("CX", [3, 2])]


@pytest.mark.parametrize("kind", ["direct", "randomized"])
@pytest.mark.parametrize("gram", [True, False])
def test_qr_update_gate_application_statevector(kind, gram):
    ropt, topt = _options(kind, 1)
    svd_r, svd_t = ropt.svd, topt.svd
    ref = RP.computational_zeros(2, 3)
    port = TP.computational_zeros(2, 3, device="cpu")
    for i, (name, sites) in enumerate(_CIRCUIT):
        g = RG.gate(name, 0.7) if name == "RY" else RG.gate(name)
        rk, tk = _keys(100 + i)
        ref = RP.apply_operator(ref, g, sites,
                                RP.QRUpdate(rank=3, svd=svd_r, gram=gram), key=rk)
        port = TP.apply_operator(port, g, sites,
                                 TP.QRUpdate(rank=3, svd=svd_t, gram=gram), key=tk)
    # Edge sites have fewer big-mode entries than small-mode ones, so their
    # Gram-QR clamps exact-zero eigenvalues at eps = 1e-13 (c128): those Q
    # columns carry noise of relative size sqrt(eps) ~ 3e-7, which the exact
    # DirectSVD discards but the randomized sketch mixes in.  That floor is
    # the algorithm's, in both packages (LAPACK under JAX vs torch).
    tol = 1e-6 if (kind == "randomized" and gram) else TOL[kind]
    assert port.max_bond() == ref.max_bond()
    sv = np.asarray(RP.to_statevector(ref))
    assert rel_err(to_numpy(TP.to_statevector(port)), sv) <= tol
    bits = np.array(np.unravel_index(np.argmax(np.abs(sv)), sv.shape))
    assert rel_err(to_numpy(TP.amplitude_exact(port, bits)),
                   RP.amplitude_exact(ref, bits)) <= tol


def test_direct_update_and_default_keys_match():
    """DirectUpdate, and apply_operator's default (key=None) path."""
    ref = RP.computational_zeros(2, 2)
    port = TP.computational_zeros(2, 2, device="cpu")
    for name, sites in [("H", [0]), ("CX", [0, 1]), ("CX", [1, 3]),
                        ("CZ", [0, 3])]:
        ref = RP.apply_operator(ref, RG.gate(name), sites, RP.DirectUpdate(2))
        port = TP.apply_operator(port, RG.gate(name), sites, TP.DirectUpdate(2))
    assert rel_err(to_numpy(TP.to_statevector(port)),
                   RP.to_statevector(ref)) <= 1e-12


def _observable(cls):
    return (cls.ZZ(0, 1) + cls.ZZ(4, 7) + 0.3 * cls.X(4) + 0.5 * cls.XX(2, 5)
            + cls.ZZ(3, 4) + (-0.7) * cls.Z(8))


@pytest.mark.parametrize("kind", ["direct", "randomized"])
@pytest.mark.parametrize("use_cache", [True, False])
def test_expectation_3x3(kind, use_cache):
    state = RP.random_peps(3, 3, 2, jax.random.PRNGKey(11))
    ropt, topt = _options(kind, 4)
    rk, tk = _keys(5)
    want = RE.expectation(state, _observable(RObs), ropt, use_cache=use_cache,
                          key=rk)
    got = TE.expectation(ref_to_port(state), _observable(TObs), topt,
                         use_cache=use_cache, key=tk)
    assert rel_err(to_numpy(got), want) <= TOL[kind]


def test_amplitude_and_inner_3x3():
    a = RP.random_peps(3, 3, 2, jax.random.PRNGKey(12))
    b = RP.random_peps(3, 3, 2, jax.random.PRNGKey(13))
    ropt, topt = _options("direct", 4)
    bits = np.array([0, 1, 1, 0, 1, 0, 0, 0, 1])
    assert rel_err(to_numpy(TB.amplitude(ref_to_port(a), bits, topt)),
                   RB.amplitude(a, bits, ropt)) <= 1e-12
    assert rel_err(to_numpy(TB.inner(ref_to_port(a), ref_to_port(b), topt)),
                   RB.inner(a, b, ropt)) <= 1e-12
    exact = RB.contract_exact_onelayer(
        [[t[int(bits[3 * i + j])] for j, t in enumerate(row)]
         for i, row in enumerate(a.sites)])
    assert rel_err(to_numpy(TB.contract_exact_onelayer(
        [[t[int(bits[3 * i + j])] for j, t in enumerate(row)]
         for i, row in enumerate(ref_to_port(a).sites)])), exact) <= 1e-12


def test_unknown_options_raise_type_error():
    state = TP.computational_zeros(2, 2, device="cpu")
    with pytest.raises(TypeError, match="unknown two-site update"):
        TP.apply_operator(state, RG.gate("CX"), [0, 1], update="full")
    with pytest.raises(TypeError, match="unknown contraction option"):
        TB.norm_squared(state, object())
    with pytest.raises(TypeError, match="unknown boundary engine"):
        TB.BMPS(4, engine="variational")
    with pytest.raises(TypeError, match="precision"):
        TB.BMPS(4, precision="bogus")
