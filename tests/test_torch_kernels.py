"""The plain versions of the port's kernels against the reference.

The plain versions (``gram_plain``, ``gram_complex_plain``,
``tall_apply_plain``, ``tiled_matmul_plain``) are what the wrappers run for
CPU tensors; they are held against ``src/repro/kernels/ref.py`` (f32 cast,
matmul, cast back) and, with bf16 multiplicands or complex operands,
against the reference Pallas kernels in interpret mode.  The CUDA kernels themselves are tested against these plain versions
in ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import gram as RG  # noqa: E402
from repro.kernels import matvec as RM  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels import tiled_matmul as RT  # noqa: E402
from repro_torch.kernels import gram as KG  # noqa: E402
from repro_torch.kernels import matvec as KM  # noqa: E402
from repro_torch.kernels import tiled_matmul as KT  # noqa: E402

# f32 plain versions vs the reference oracles: the same f32 products summed
# in another order — a few f32 ulps of the result's scale.
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


@pytest.mark.parametrize("shape", [(300, 7), (1000, 72), (64, 1), (40, 130)])
def test_gram_plain_matches_reference_oracle(shape):
    a = _rand(0, *shape)
    got = KG.gram(torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == (shape[1], shape[1])
    assert _rel(got.numpy(), ref.gram(jnp.asarray(a))) <= F32_TOL


@pytest.mark.parametrize("shape", [(200, 9), (517, 24)])
def test_gram_complex_plain_matches_reference(shape):
    a = _rand(1, *shape, complex_=True)
    got = KG.gram_complex(torch.from_numpy(a))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref.gram_complex(jnp.asarray(a))) <= F32_TOL
    # the imaginary part is X - X^T: exactly antisymmetric
    im = got.imag.numpy()
    np.testing.assert_array_equal(im, -im.T)


GRAM_COMPLEX_SHAPES = [(300, 72), (216, 36), (50, 1), (33, 130)]


@pytest.mark.parametrize("compute", [None, "bfloat16"])
@pytest.mark.parametrize("shape", GRAM_COMPLEX_SHAPES)
def test_gram_complex_matches_reference_kernel(shape, compute):
    """``gram_complex_plain`` and the CPU path of ``gram_complex`` against
    the reference's planar ``gram_complex`` in interpret mode: the same
    (bf16-rounded, under ``compute``) f32 products summed in another order.
    With bf16 multiplicands the error from the exact product is engaged and
    within the 2e-2 ``kernel_bf16_gemm`` budget."""
    a = _rand(11, *shape, complex_=True)
    want = np.asarray(RG.gram_complex(jnp.asarray(a), interpret=True,
                                      compute=compute))
    t = torch.from_numpy(a)
    for got in (KG.gram_complex_plain(t, compute),
                KG.gram_complex(t, compute=compute)):
        assert got.dtype == torch.complex64 and got.shape == (shape[1],) * 2
        assert _rel(got.numpy(), want) <= F32_TOL
    if compute is not None:
        exact = a.astype(np.complex128).conj().T @ a.astype(np.complex128)
        err = _rel(got.numpy(), exact)
        assert 1e-5 < err <= 2e-2, err


@pytest.mark.parametrize("compute", [None, "bfloat16"])
@pytest.mark.parametrize("shape", GRAM_COMPLEX_SHAPES)
def test_gram_complex_plain_is_exactly_hermitian(shape, compute):
    g = KG.gram_complex_plain(torch.from_numpy(_rand(12, *shape,
                                                     complex_=True)), compute)
    assert torch.equal(g.real, g.real.T)
    assert torch.equal(g.imag, -g.imag.T)
    assert torch.count_nonzero(torch.diagonal(g.imag)) == 0


@pytest.mark.parametrize("dtype", [torch.complex128, torch.float32])
def test_gram_complex_refuses_other_dtypes(dtype):
    a = torch.from_numpy(_rand(13, 20, 4, complex_=True))
    a = a.to(dtype) if dtype.is_complex else a.real.contiguous()
    with pytest.raises(TypeError, match="complex64"):
        KG.gram_complex(a)


@pytest.mark.parametrize("m,k,n", [(300, 24, 24), (1000, 144, 144),
                                   (77, 1, 5), (64, 37, 200)])
def test_tall_apply_plain_matches_reference_oracle(m, k, n):
    a, b = _rand(2, m, k), _rand(3, k, n)
    got = KM.tall_apply(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(got.numpy(), ref.matmul(jnp.asarray(a), jnp.asarray(b))) <= F32_TOL


@pytest.mark.parametrize("m,k,n,transposed", [(72, 900, 72, True),
                                              (12, 216, 12, True),
                                              (130, 257, 129, False),
                                              (1, 5, 1, False)])
def test_tiled_matmul_plain_matches_reference_oracle(m, k, n, transposed):
    a = _rand(4, k, m).T if transposed else _rand(4, m, k)
    b = _rand(5, k, n)
    ta = torch.from_numpy(np.ascontiguousarray(a.T)).T if transposed \
        else torch.from_numpy(a)
    got = KT.tiled_matmul(ta, torch.from_numpy(b))
    assert _rel(got.numpy(), ref.matmul(jnp.asarray(a), jnp.asarray(b))) <= F32_TOL


def test_planar_matmul_complex_matches_reference():
    a = _rand(6, 150, 12, complex_=True)
    b = _rand(7, 12, 20, complex_=True)
    got = KM.planar_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = RM.planar_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) <= F32_TOL
    assert _rel(got.numpy(), a @ b) <= F32_TOL


@pytest.mark.parametrize("kernel", ["gram", "tall_apply", "tiled_matmul"])
def test_bf16_multiplicands_match_reference_kernel(kernel):
    """bf16-rounded multiplicands, f32 accumulation: the plain version and
    the reference Pallas kernel (interpret mode) round the same operands, so
    they agree to f32 accumulation order; both stay within the 2e-2
    ``kernel_bf16_gemm`` budget of the exact product."""
    a, b = _rand(8, 256, 40), _rand(9, 40, 24)
    if kernel == "gram":
        got = KG.gram(torch.from_numpy(a), compute="bfloat16")
        want = RG.gram(jnp.asarray(a), interpret=True, compute="bfloat16")
        exact = a.T @ a
    elif kernel == "tall_apply":
        got = KM.tall_apply(torch.from_numpy(a), torch.from_numpy(b),
                            compute="bfloat16")
        want = RM.tall_apply(jnp.asarray(a), jnp.asarray(b), interpret=True,
                             compute="bfloat16")
        exact = a @ b
    else:
        got = KT.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              compute="bfloat16")
        want = RT.tiled_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True,
                               compute="bfloat16")
        exact = a @ b
    assert _rel(got.numpy(), want) <= F32_TOL
    err = _rel(got.numpy(), exact)
    assert 1e-5 < err <= 2e-2, err   # engaged, and bounded


def test_wrappers_count_launches_only_on_the_card():
    before = (KG.gram.launches, KG.gram_complex.launches,
              KM.tall_apply.launches, KM.tall_apply_complex.launches,
              KT.tiled_matmul.launches)
    a = torch.from_numpy(_rand(10, 50, 6))
    ac = torch.from_numpy(_rand(10, 50, 6, complex_=True))
    KG.gram(a)
    KG.gram_complex(ac)
    KM.tall_apply(a, a.T.contiguous())
    KM.tall_apply_complex(ac, ac.T.contiguous())
    KM.planar_matmul(ac, ac.T)
    KT.tiled_matmul(a.T, a)
    assert (KG.gram.launches, KG.gram_complex.launches,
            KM.tall_apply.launches, KM.tall_apply_complex.launches,
            KT.tiled_matmul.launches) == before


# (case, M, K, N): a c64 product, a conj view of A, a transposed (strided)
# B, bf16 multiplicands, and K = 500, above the planar form's old limit of
# 440 complex k (its doubled real slab no longer fit in shared memory)
TALL_APPLY_COMPLEX_CASES = [("c64", 300, 24, 20), ("conj_a", 150, 36, 12),
                            ("strided_b", 150, 36, 12),
                            ("bfloat16", 256, 40, 24), ("k500", 64, 500, 12)]


@pytest.mark.parametrize("case,m,k,n", TALL_APPLY_COMPLEX_CASES)
def test_tall_apply_complex_matches_reference_planar_matmul(case, m, k, n):
    """``tall_apply_complex_plain``, the CPU path of ``tall_apply_complex``
    and ``planar_matmul`` against the reference's ``planar_matmul`` in
    interpret mode, on the same numpy inputs: the same f32 products summed
    in another order."""
    a, b = _rand(20, m, k, complex_=True), _rand(21, k, n, complex_=True)
    compute = "bfloat16" if case == "bfloat16" else None
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if case == "conj_a":
        ta, a = ta.conj(), a.conj()
    if case == "strided_b":
        tb = torch.from_numpy(np.ascontiguousarray(b.T)).T
        assert tb.stride() == (1, k)
    want = np.asarray(RM.planar_matmul(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True, compute=compute))
    for got in (KM.tall_apply_complex_plain(ta, tb, compute),
                KM.tall_apply_complex(ta, tb, compute=compute),
                KM.planar_matmul(ta, tb, compute=compute)):
        assert got.dtype == torch.complex64 and got.shape == (m, n)
        assert _rel(got.numpy(), want) <= F32_TOL
    if compute is not None:   # engaged, and within the bf16 budget
        err = _rel(got.numpy(), a.astype(np.complex128) @ b)
        assert 1e-5 < err <= 2e-2, err


def test_tall_apply_complex_refuses_other_dtypes():
    a = torch.from_numpy(_rand(22, 20, 4, complex_=True))
    with pytest.raises(TypeError, match="complex64"):
        KM.tall_apply_complex(a.to(torch.complex128), a.T)
    with pytest.raises(TypeError, match="complex64"):
        KM.tall_apply_complex(a, a.real.T)
