"""The hand-written CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA card (the kernels have no CPU mode): each is
marked ``cuda`` and skips from a fixture when no card is present.  The file
imports neither JAX nor the reference package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gram as KG  # noqa: E402
from repro_torch.kernels import matvec as KM  # noqa: E402
from repro_torch.kernels import tiled_matmul as KT  # noqa: E402

# kernel vs plain version: the same f32 products summed in another order
F32_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _crand(seed, *shape):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)


def _crel(got, want):
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(82944, 72), (2304, 72), (216, 12), (1000, 1),
                                 (777, 70), (5000, 200)])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_gram_kernel_matches_plain(cuda, m, n, compute):
    a = _crand(0, m, n)
    before = KG.gram.launches
    got = KG.gram(a, compute=compute)
    torch.cuda.synchronize()
    assert KG.gram.launches == before + 1
    assert _crel(got, KG.gram_plain(a, compute)) <= F32_TOL
    assert torch.equal(got, got.T)      # mirrored: exactly symmetric


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(82944, 144, 144), (216, 24, 24),
                                   (1000, 1, 1), (777, 70, 200),
                                   (513, 600, 130)])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_tall_apply_kernel_matches_plain(cuda, m, k, n, compute):
    a, b = _crand(1, m, k), _crand(2, k, n)
    before = KM.tall_apply.launches
    got = KM.tall_apply(a, b, compute=compute)
    torch.cuda.synchronize()
    assert KM.tall_apply.launches == before + 1
    assert _crel(got, KM.tall_apply_plain(a, b, compute)) <= F32_TOL


@pytest.mark.cuda
def test_tall_apply_refuses_a_slab_beyond_shared_memory(cuda):
    with pytest.raises(ValueError, match="shared memory"):
        KM.tall_apply(_crand(3, 64, 900), _crand(4, 900, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,transposed", [(72, 82944, 72, True),
                                              (12, 216, 12, True),
                                              (130, 257, 129, False),
                                              (1, 5, 1, False)])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_tiled_matmul_kernel_matches_plain(cuda, m, k, n, transposed, compute):
    a = _crand(5, k, m).T if transposed else _crand(5, m, k)
    b = _crand(6, k, n)
    before = KT.tiled_matmul.launches
    got = KT.tiled_matmul(a, b, compute=compute)
    torch.cuda.synchronize()
    assert KT.tiled_matmul.launches == before + 1
    assert _crel(got, KT.tiled_matmul_plain(a, b, compute)) <= F32_TOL


@pytest.mark.cuda
def test_gram_complex_on_the_card_is_hermitian_and_matches(cuda):
    a = torch.complex(_crand(7, 4096, 40), _crand(8, 4096, 40))
    got = KG.gram_complex(a)
    want = a.conj().T @ a
    assert _crel(got, want) <= F32_TOL
    assert torch.equal(got.imag, -got.imag.T)
