"""The port's ``ops.matmul`` and ``ops.gram`` against the reference's.

On CPU tensors both entry points run their plain versions
(``tiled_matmul_plain``, ``gram_plain``, ``gram_complex_plain``); they are
held against ``repro.kernels.ops.matmul``/``gram`` on the same inputs, made
with numpy, through the reference's jnp oracle (``use_pallas=False``) and
through its Pallas kernels in interpret mode (``use_pallas=True``).  The
CUDA route is tested in ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as R  # noqa: E402
from repro_torch.kernels import gram as KG  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tiled_matmul as KT  # noqa: E402

# f32 products summed in another order than the reference's: a few f32
# ulps of the result's scale.
F32_TOL = 1e-5


def _rand(seed, *shape, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _operand(x, transposed):
    """``x`` as a torch tensor; with ``transposed``, as the transpose view
    of a row-major copy of ``x.T`` (the layout ``x.T`` of the main path)."""
    if transposed:
        return torch.from_numpy(np.ascontiguousarray(x.T)).T
    return torch.from_numpy(x)


# (M, K, N, a transposed): the main path's 72-wide output at a short K, a
# ragged one, small and degenerate row-major ones
MATMUL_CASES = [(72, 300, 72, True), (12, 216, 12, True),
                (20, 130, 36, True), (130, 257, 129, False), (1, 5, 1, False)]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("m,k,n,transposed", MATMUL_CASES)
def test_matmul_matches_reference_ops(m, k, n, transposed, use_pallas):
    a, b = _rand(1, m, k), _rand(2, k, n)
    ta = _operand(a, transposed)
    assert ta.is_contiguous() != transposed
    got = ops.matmul(ta, torch.from_numpy(b))
    want = R.matmul(jnp.asarray(a), jnp.asarray(b), use_pallas=use_pallas)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got.numpy(), want) <= F32_TOL


@pytest.mark.parametrize("m,k,n,transposed", [(72, 300, 72, True),
                                              (130, 257, 129, False)])
def test_matmul_bf16_matches_reference_kernel(m, k, n, transposed):
    """``compute`` keeps its name and meaning: bf16-rounded multiplicands,
    f32 accumulation, as the reference's Pallas kernel computes them."""
    a, b = _rand(3, m, k), _rand(4, k, n)
    got = ops.matmul(_operand(a, transposed), torch.from_numpy(b),
                     compute="bfloat16")
    want = R.matmul(jnp.asarray(a), jnp.asarray(b), use_pallas=True,
                    compute="bfloat16")
    assert _rel(got.numpy(), want) <= F32_TOL
    assert 1e-5 < _rel(got.numpy(), a @ b) <= 2e-2   # engaged, and bounded


# (M, N, complex64): tall real and complex operands, a narrow one
GRAM_CASES = [(300, 24, False), (1000, 72, False), (50, 1, False),
              (300, 24, True), (200, 72, True), (40, 3, True)]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("m,n,complex_", GRAM_CASES)
def test_gram_matches_reference_ops(m, n, complex_, use_pallas):
    a = _rand(5, m, n, complex_=complex_)
    got = ops.gram(torch.from_numpy(a))
    want = R.gram(jnp.asarray(a), use_pallas=use_pallas)
    assert got.dtype == torch.from_numpy(a).dtype and got.shape == (n, n)
    assert _rel(got.numpy(), want) <= F32_TOL


def test_gram_bf16_matches_reference_kernel():
    a = _rand(6, 256, 40)
    got = ops.gram(torch.from_numpy(a), compute="bfloat16")
    want = R.gram(jnp.asarray(a), use_pallas=True, compute="bfloat16")
    assert _rel(got.numpy(), want) <= F32_TOL
    assert 1e-5 < _rel(got.numpy(), a.T @ a) <= 2e-2


@pytest.mark.parametrize("entry", ["matmul", "gram", "gram_complex"])
def test_kernel_route_on_a_cpu_tensor_runs_the_plain_version(entry):
    """``use_kernel=True`` on a CPU tensor reaches the kernel wrapper, which
    runs its plain version (bit for bit) and counts no launch."""
    before = (KT.tiled_matmul.launches, KG.gram.launches,
              KG.gram_complex.launches)
    if entry == "matmul":
        a = _operand(_rand(7, 72, 90), True)
        b = torch.from_numpy(_rand(8, 90, 72))
        got = ops.matmul(a, b, use_kernel=True)
        want = KT.tiled_matmul_plain(a, b)
    elif entry == "gram":
        a = torch.from_numpy(_rand(9, 90, 12))
        got = ops.gram(a, use_kernel=True)
        want = KG.gram_plain(a)
    else:
        a = torch.from_numpy(_rand(10, 90, 12, complex_=True))
        got = ops.gram(a, use_kernel=True)
        want = KG.gram_complex_plain(a)
    assert torch.equal(got, want)
    assert (KT.tiled_matmul.launches, KG.gram.launches,
            KG.gram_complex.launches) == before


def test_use_kernel_defaults_to_the_operand_device():
    """``None`` routes a CPU operand to the plain version, as the
    reference's ``None`` routes off a TPU to its oracle."""
    a = torch.from_numpy(_rand(11, 40, 8))
    assert torch.equal(ops.matmul(a.T, a), KT.tiled_matmul_plain(a.T, a))
    assert torch.equal(ops.gram(a), KG.gram_plain(a))
