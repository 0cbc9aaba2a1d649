"""The kernel sites at complex64: the reference's Pallas kernels (interpret
mode, as its own tests run them) against the port's kernel forms on the CPU,
which run the kernels' plain versions.

A 3x3 two-layer norm reaches ``gram``, ``tall_apply`` and
``zipup_first_twolayer``; a 3x3 amplitude reaches ``zipup_first_onelayer``.
Scalars agree to 1e-4 relative (complex64 arithmetic summed in different
orders through randomized truncations).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_helpers import JaxKey, ref_to_port, rel_err, to_numpy  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import gates as RG  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.kernels import dispatch as RD  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.kernels import dispatch as TD  # noqa: E402

TOL_C64 = 1e-4


@pytest.fixture(scope="module")
def state_c64():
    """A normalized-ish 3x3 c64 state built from gates (a random c64 PEPS
    would let the two-layer scalars drift far from O(1))."""
    q = RP.computational_zeros(3, 3, dtype=jnp.complex64)
    rng = np.random.default_rng(0)
    for s in range(9):
        q = RP.apply_operator(q, RG.gate("RY", rng.uniform(0, np.pi)), [s])
    for a, b in [(0, 1), (1, 2), (3, 4), (0, 3), (4, 7), (2, 5), (7, 8)]:
        q = RP.apply_operator(q, RG.gate("CX"), [a, b], RP.QRUpdate(rank=2))
    return q


@pytest.fixture
def kernel_modes():
    prev_r = RD.set_kernel_backend("pallas")
    prev_i = RD.set_interpret_mode("interpret")
    prev_t = TD.set_kernel_backend("kernel")
    RD.reset_dispatch_stats()
    TD.reset_dispatch_stats()
    yield
    RD.set_kernel_backend(prev_r)
    RD.set_interpret_mode(prev_i)
    TD.set_kernel_backend(prev_t)


def _option_pair(chi):
    return (RB.BMPS.randomized(chi, niter=2, oversample=4),
            TB.BMPS.randomized(chi, niter=2, oversample=4))


def test_twolayer_norm_through_kernel_sites(state_c64, kernel_modes):
    ropt, topt = _option_pair(4)
    want = RB.norm_squared(state_c64, ropt, key=jax.random.PRNGKey(1))
    got = TB.norm_squared(ref_to_port(state_c64), topt, key=JaxKey(1))
    assert got.dtype == torch.complex64
    assert rel_err(to_numpy(got), want) <= TOL_C64
    st = TD.dispatch_stats()
    for site in ("gram", "tall_apply", "zipup_first_twolayer"):
        assert st[f"kernel_{site}_calls"] > 0 and st[f"dense_{site}_calls"] == 0
        assert RD.dispatch_stats()[f"pallas_{site}_calls"] > 0


def test_amplitude_through_kernel_sites(state_c64, kernel_modes):
    ropt, topt = _option_pair(4)
    sv = np.asarray(RP.to_statevector(state_c64))
    bits = np.array(np.unravel_index(np.argmax(np.abs(sv)), sv.shape))
    want = RB.amplitude(state_c64, bits, ropt, key=jax.random.PRNGKey(3))
    got = TB.amplitude(ref_to_port(state_c64), bits, topt, key=JaxKey(3))
    assert rel_err(to_numpy(got), want) <= TOL_C64
    assert TD.dispatch_stats()["kernel_zipup_first_onelayer_calls"] > 0
