"""Shared bridges between the JAX reference and the PyTorch port.

Imported by the ``test_torch_*`` files (``tests/`` is on ``sys.path``):
numpy converters both ways and :class:`JaxKey`, a key object backed by
``jax.random`` and the reference's own ``_random_sketch``, so the port's
randomized SVD draws exactly the reference's sketches and randomized paths
compare to rounding instead of statistically.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import peps as RP  # noqa: E402
from repro.core.rsvd import _random_sketch  # noqa: E402
from repro_torch.convert import peps_from_numpy, peps_to_numpy  # noqa: E402

CPU = "cpu"

_JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64,
        torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}
_TORCH = {v: k for k, v in _JNP.items()}


class JaxKey:
    """Key object of the port's protocol (``split``/``fold_in``/``sketch``/
    ``uniform``/``rademacher``) on top of a ``jax.random`` key."""

    def __init__(self, key):
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key

    def split(self, n):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i):
        return JaxKey(jax.random.fold_in(self.key, i))

    def sketch(self, shape, dtype, device):
        arr = _random_sketch(self.key, tuple(shape), _JNP[dtype])
        return torch.from_numpy(np.array(arr)).to(device)

    def uniform(self, shape, lo, hi, dtype, device):
        arr = jax.random.uniform(self.key, tuple(shape), _JNP[dtype], lo, hi)
        return torch.from_numpy(np.array(arr)).to(device)

    def rademacher(self, shape, dtype, device):
        arr = jax.random.rademacher(self.key, tuple(shape), jnp.int32)
        return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def to_torch(x, device=CPU):
    return torch.from_numpy(np.array(x)).to(device)


def to_numpy(t):
    return t.detach().cpu().numpy()


def torch_dtype(jdtype):
    return _TORCH[jnp.dtype(jdtype).type]


def ref_to_port(state, dtype=None):
    """The reference PEPS as the port's PEPS on the CPU."""
    return peps_from_numpy([[np.asarray(t) for t in row] for row in state.sites],
                           float(state.log_scale), dtype=dtype, device=CPU)


def port_to_ref(state):
    sites, log_scale = peps_to_numpy(state)
    return RP.PEPS([[jnp.asarray(t) for t in row] for row in sites], log_scale)


def rows_to_torch(rows, device=CPU):
    return [[to_torch(t, device) for t in row] for row in rows]


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def test_jax_key_reproduces_reference_sketch():
    key = JaxKey(3)
    want = _random_sketch(key.key, (4, 5), jnp.complex128)
    got = key.sketch((4, 5), torch.complex128, CPU)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    k1, k2 = key.split(2)
    r1, r2 = jax.random.split(key.key)
    np.testing.assert_array_equal(np.asarray(k1.key), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(k2.key), np.asarray(r2))


def test_numpy_bridges_round_trip():
    ref = RP.random_peps(2, 3, 2, jax.random.PRNGKey(1))
    port = ref_to_port(ref)
    assert port.dtype == torch.complex128 and port.device.type == "cpu"
    back = port_to_ref(port)
    for r0, r1 in zip(ref.sites, back.sites):
        for a, b in zip(r0, r1):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
