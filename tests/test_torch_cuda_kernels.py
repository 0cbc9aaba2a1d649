"""The hand-written CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA card (the kernels have no CPU mode): each is
marked ``cuda`` and skips from a fixture when no card is present.  The file
imports neither JAX nor the reference package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as KF  # noqa: E402
from repro_torch.kernels import gram as KG  # noqa: E402
from repro_torch.kernels import matvec as KM  # noqa: E402
from repro_torch.kernels import ssd_scan as KS  # noqa: E402
from repro_torch.kernels import tiled_matmul as KT  # noqa: E402
from repro_torch.kernels import zipup_block as KZ  # noqa: E402

# kernel vs plain version: the same f32 products summed in another order
F32_TOL = 1e-5
# bf16 outputs: both round the same f32 result to bf16; a sum taken in
# another order can flip the last bit of an entry (2^-8 relative)
BF16_TOL = 4e-3
# the bf16 flash kernel keeps P exact, so only such flips remain (about
# 4e-5); P rounded to bf16 reads about 1e-3
FLASH_BF16_TOL = 4e-4
# ``lo_piece_probe``'s column against its exact value: about 1e-2 with all
# three pieces of P, about 0.6 without the third
PROBE_TOL = 0.1


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
                                 (777, 70), (5000, 200), (33, 130)])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_gram_kernel_matches_plain(cuda, m, n, compute):
    a = _crand(0, m, n)
    before = KG.gram.launches
    got = KG.gram(a, compute=compute)
    torch.cuda.synchronize()
    assert KG.gram.launches == before + 1
    assert _crel(got, KG.gram_plain(a, compute)) <= F32_TOL
    assert torch.equal(got, got.T)      # mirrored: exactly symmetric
    assert torch.equal(KG.gram(a, compute=compute), got)   # fixed order


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
def test_tall_apply_takes_any_reduction_depth(cuda):
    """B is staged over K: K = 900 real and K = 488 complex (beyond the old
    resident slab's shared memory) run and match the plain versions."""
    a, b = _crand(3, 64, 900), _crand(4, 900, 8)
    assert _crel(KM.tall_apply(a, b), KM.tall_apply_plain(a, b)) <= F32_TOL
    a, b = _c64(30, 64, 488), _c64(32, 488, 8)
    assert _crel(KM.tall_apply_complex(a, b),
                 KM.tall_apply_complex_plain(a, b)) <= F32_TOL


# the main path's shapes (Q = A P at two heights and two Gram sizes, the
# projections' N = 64), then odd ones
TALL_APPLY_COMPLEX_SHAPES = [(82944, 72, 72), (82944, 72, 64), (2304, 72, 72),
                             (1296, 72, 72), (1, 1, 1), (777, 70, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", TALL_APPLY_COMPLEX_SHAPES)
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_tall_apply_complex_kernel_matches_plain(cuda, m, k, n, compute):
    """One launch reads A's c64 storage in place: it matches the plain
    version, repeats bit for bit, launches no real tall-apply, and
    allocates only C (no copy of A)."""
    a, b = _c64(40, m, k), _c64(42, k, n)
    before = (KM.tall_apply_complex.launches, KM.tall_apply.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = KM.tall_apply_complex(a, b, compute=compute)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= got.numel() * 8 + 2**20
    assert (KM.tall_apply_complex.launches, KM.tall_apply.launches) == \
        (before[0] + 1, before[1])
    assert got.dtype == torch.complex64 and got.shape == (m, n)
    assert _crel(got, KM.tall_apply_complex_plain(a, b, compute)) <= F32_TOL
    assert torch.equal(KM.tall_apply_complex(a, b, compute=compute), got)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_tall_apply_complex_reads_conj_and_strided_views(cuda, compute):
    """rSVD's projection ``q_t.conj() @ vh_small.T``: a conj view of A, a
    transposed B and a conj B, read through their strides and conj bits."""
    a, vh = _c64(50, 3000, 72), _c64(52, 72, 72)[:64]
    for x, y in ((a.conj(), vh.T), (a, vh.T.conj()), (a.conj(), vh.T.conj()),
                 (a, _c64(54, 72, 72)[:, :64])):
        got = KM.tall_apply_complex(x, y, compute=compute)
        want = KM.tall_apply_complex_plain(x, y, compute)
        assert _crel(got, want) <= F32_TOL
        assert _crel(KM.planar_matmul(x, y, compute=compute), want) <= F32_TOL


@pytest.mark.cuda
def test_auto_runs_a_deep_complex_tall_apply_on_the_kernel(cuda):
    """(200,000 x 488) complex64 in ``auto`` mode through the ``tall_apply``
    site: the tall-skinny gate routes it to the kernel, which runs it."""
    from repro_torch.core.orthogonalize import tall_project
    from repro_torch.kernels import dispatch
    a, mat = _c64(60, 200000, 488), _c64(62, 488, 488)
    prev = dispatch.set_kernel_backend("auto")
    try:
        dispatch.reset_dispatch_stats()
        before = KM.tall_apply_complex.launches
        got = tall_project(a, mat, 1)
        torch.cuda.synchronize()
        assert dispatch.dispatch_stats()["kernel_tall_apply_calls"] == 1
        assert KM.tall_apply_complex.launches == before + 1
    finally:
        dispatch.set_kernel_backend(prev)
    assert _crel(got, a @ mat) <= F32_TOL


def _tiled_operands(m, k, n, transposed, offset):
    """op(A) (M, K) and B (K, N): A as the transpose view of a row-major
    (K, M) matrix or row-major itself; with ``offset``, both views start one
    float into their storage, so that no 16-byte copy is aligned."""
    def view(seed, rows, cols):
        flat = _crand(seed, rows * cols + offset)[offset:]
        return flat.view(rows, cols)

    a = view(5, k, m).T if transposed else view(5, m, k)
    return a, view(6, k, n)


# (M, K, N, A transposed, offset in floats): the main path's 72-wide output
# over K = 82,944, and over a ragged K; a row-major multi-tile output; a
# misaligned view; small and degenerate shapes
TILED_MATMUL_CASES = [(72, 82944, 72, True, 0), (72, 82943, 72, True, 0),
                      (200, 3000, 130, False, 0), (72, 82944, 72, True, 1),
                      (12, 216, 12, True, 0), (130, 257, 129, False, 0),
                      (1, 5, 1, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,transposed,offset", TILED_MATMUL_CASES)
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_tiled_matmul_kernel_matches_plain(cuda, m, k, n, transposed, offset,
                                           compute):
    a, b = _tiled_operands(m, k, n, transposed, offset)
    before = KT.tiled_matmul.launches
    got = KT.tiled_matmul(a, b, compute=compute)
    torch.cuda.synchronize()
    assert KT.tiled_matmul.launches == before + 1
    assert _crel(got, KT.tiled_matmul_plain(a, b, compute)) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_tiled_matmul_repeats_bit_for_bit(cuda, compute):
    """The splits' partials are summed in a fixed order: no atomics."""
    a, b = _tiled_operands(72, 82944, 72, True, 0)
    got = KT.tiled_matmul(a, b, compute=compute)
    assert torch.equal(KT.tiled_matmul(a, b, compute=compute), got)


@pytest.mark.cuda
def test_ops_matmul_on_a_cuda_tensor_launches_tiled_matmul_once(cuda):
    from repro_torch.kernels import ops
    a, b = _tiled_operands(72, 82944, 72, True, 0)
    before = KT.tiled_matmul.launches
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert KT.tiled_matmul.launches == before + 1
    assert torch.equal(got, KT.tiled_matmul(a, b))
    assert _crel(got, KT.tiled_matmul_plain(a, b)) <= F32_TOL


def _c64(seed, m, n):
    return torch.complex(_crand(seed, m, n), _crand(seed + 1, m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(82944, 72), (46656, 72), (82944, 36),
                                 (2304, 72), (1296, 72), (36, 36), (1, 1),
                                 (2304, 1), (5000, 200), (33, 130)])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_gram_complex_on_the_card_is_hermitian_and_matches(cuda, m, n,
                                                           compute):
    """One kernel (and its reduce) reads the c64 storage: it matches the
    plain version, is exactly Hermitian, repeats bit for bit, and launches
    neither the real Gram nor the tiled GEMM."""
    a = _c64(7, m, n)
    before = (KG.gram_complex.launches, KG.gram.launches,
              KT.tiled_matmul.launches)
    got = KG.gram_complex(a, compute=compute)
    torch.cuda.synchronize()
    assert (KG.gram_complex.launches, KG.gram.launches,
            KT.tiled_matmul.launches) == (before[0] + 1,) + before[1:]
    assert got.dtype == torch.complex64 and got.shape == (n, n)
    assert _crel(got, KG.gram_complex_plain(a, compute)) <= F32_TOL
    assert torch.equal(got.real, got.real.T)
    assert torch.equal(got.imag, -got.imag.T)
    assert torch.equal(KG.gram_complex(a, compute=compute), got)


@pytest.mark.cuda
def test_gram_complex_of_a_conj_view(cuda):
    a = _c64(9, 3000, 72)
    got = KG.gram_complex(a.conj())
    b = a.conj().resolve_conj()
    assert _crel(got, b.mH @ b) <= F32_TOL
    assert _crel(got, KG.gram_complex(a).conj()) <= F32_TOL


@pytest.mark.cuda
def test_gram_complex_refuses_what_the_kernel_does_not_take(cuda):
    a = _c64(11, 500, 80)
    with pytest.raises(TypeError, match="complex64"):
        KG.gram_complex(a.to(torch.complex128))
    with pytest.raises(ValueError, match="row-major contiguous"):
        KG.gram_complex(a[:, :72])
    with pytest.raises(ValueError, match="row-major contiguous"):
        KG.gram_complex(a.T)


# ------------------------------------------------------- flash attention ----
def _qkv(seed, b, hq, hkv, s, sk, d, dtype, layout):
    """(B, H, S, D) operands; layout "bshd" gives transposed views of
    (B, S, H, D) storage, as the model passes them."""
    def one(i, h, n):
        if layout == "bshd":
            return _crand(seed + i, b, n, h, d).to(dtype).transpose(1, 2)
        return _crand(seed + i, b, h, n, d).to(dtype)
    return one(0, hq, s), one(1, hkv, sk), one(2, hkv, sk)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,sk,d,causal,layout", [
    (1, 4, 2, 300, 300, 80, True, "bhsd"),     # GQA, ragged S
    (1, 4, 2, 300, 300, 80, False, "bhsd"),
    (2, 4, 4, 128, 128, 16, True, "bshd"),     # the smoke model's shape
    (1, 8, 1, 130, 130, 64, True, "bhsd"),     # MQA
    (1, 2, 2, 64, 64, 128, True, "bhsd"),      # the largest head dim
    (1, 2, 2, 100, 75, 32, False, "bhsd"),     # fewer keys than queries
    (2, 32, 32, 512, 512, 80, True, "bshd"),   # Zamba2 heads, shorter S
    (1, 4, 2, 200, 200, 48, True, "bshd"),     # D = 48
    (1, 4, 2, 150, 150, 24, False, "bhsd"),    # D = 24, padded to 32
    (1, 32, 8, 256, 256, 128, True, "bshd"),   # qwen3-4b heads, GQA 4
    (1, 15, 5, 200, 200, 64, True, "bshd"),    # smollm-360m heads, GQA 3
    (1, 32, 4, 256, 256, 128, True, "bshd"),   # qwen3-moe heads, GQA 8
    (1, 20, 20, 1500, 1500, 64, False, "bshd"),  # whisper encoder, ragged
    (1, 20, 20, 64, 1500, 64, False, "bshd"),  # whisper cross-attention
    (4, 20, 20, 1, 1500, 64, False, "bshd"),   # whisper cross, one token
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, s, sk, d,
                                              causal, layout, dtype):
    q, k, v = _qkv(10, b, hq, hkv, s, sk, d, dtype, layout)
    before = KF.flash_attention.launches
    got = KF.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert KF.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = KF.flash_attention_plain(q, k, v, causal=causal)
    tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    assert _crel(got.float(), want.float()) <= tol


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = _crand(11, 1, 2, 16, 144)
    with pytest.raises(ValueError, match="head dimension"):
        KF.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        KF.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="unit stride"):
        KF.flash_attention(q.transpose(2, 3), q.transpose(2, 3),
                           q.transpose(2, 3))
    # bf16: rows of 84 elements (not 16-byte multiples), D = 20
    q = _crand(12, 1, 2, 16, 84).to(torch.bfloat16)[..., :80]
    with pytest.raises(ValueError, match="multiples of 8"):
        KF.flash_attention(q, q, q)
    q = _crand(13, 1, 2, 16, 20).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        KF.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_attention_bf16_keeps_the_third_piece_of_p(cuda, seed):
    """The output column of ``lo_piece_probe`` is a difference of two
    weights that agree in the 16 bits hi and mid keep: the kernel meets its
    exact value only if it multiplies lo too.  The plain sum of two pieces
    misses it on the same inputs."""
    q, k, v, want = KF.lo_piece_probe("cuda", seed)
    got = KF.flash_attention(q, k, v, causal=False)[0, 0, :, 0]
    two = KF.flash_attention_split_plain(q, k, v, causal=False,
                                         pieces=2)[0, 0, :, 0]
    assert _crel(got.double(), want) <= PROBE_TOL
    assert _crel(two.double(), want) > PROBE_TOL


# -------------------------------------------------------------- ssd scan ----
def _ssd(seed, bh, length, p, n, dtype):
    x = _crand(seed, bh, length, p).to(dtype)
    b = (0.5 * _crand(seed + 1, bh, length, n)).to(dtype)
    c = (0.5 * _crand(seed + 2, bh, length, n)).to(dtype)
    a = -0.1 * _crand(seed + 3, bh, length).abs()
    return x, b, c, a


_SSD_SHAPES = [
    (4, 1000, 64, 64, 128),    # ragged last chunk at Zamba2's P, N
    (3, 200, 16, 16, 64),
    (2, 40, 16, 16, 16),       # the smoke model's chunk
    (2, 256, 64, 128, 64),     # N = 128
    (2, 77, 32, 16, 48),       # chunk not a power of two
]
_SSD_CASES = [pytest.param(*shape, dtype, id=f"{name}-" + "-".join(map(str, shape)))
              for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
              for shape in _SSD_SHAPES] + [
    # mamba2-2.7b's N = 128 at chunk 128: only the bf16 kernels take it
    pytest.param(2, 300, 64, 128, 128, torch.bfloat16,
                 id="bf16-2-300-64-128-128"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,length,p,n,chunk,dtype", _SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, bh, length, p, n, chunk, dtype):
    x, b, c, a = _ssd(20, bh, length, p, n, dtype)
    before = KS.ssd_scan.launches
    y, state = KS.ssd_scan(x, b, c, a, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert KS.ssd_scan.launches == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    y0, state0 = KS.ssd_scan_plain(x, b, c, a, chunk=chunk, return_state=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _crel(y.float(), y0.float()) <= tol
    assert _crel(state, state0) <= F32_TOL
    assert torch.equal(KS.ssd_scan(x, b, c, a, chunk=chunk), y)


@pytest.mark.cuda
def test_ssd_scan_reads_strided_operands(cuda):
    """B and C as (BH, L, N) views of a wider projection, as the model's
    split makes them."""
    x, _, _, a = _ssd(30, 2, 300, 64, 64, torch.float32)
    bc = _crand(31, 2, 300, 160)
    b, c = bc[..., :64], bc[..., 80:144]
    got = KS.ssd_scan(x, b, c, a, chunk=128)
    assert _crel(got, KS.ssd_scan_plain(x, b, c, a, chunk=128)) <= F32_TOL


@pytest.mark.cuda
def test_ssd_scan_bf16_reads_strided_operands(cuda):
    """The bf16 kernels read B and C as views of a wider bf16 projection
    through their strides; a view that breaks the 16-byte alignment of
    their cp.async rows is refused."""
    x, _, _, a = _ssd(32, 2, 300, 64, 64, torch.bfloat16)
    bc = _crand(33, 2, 300, 160).to(torch.bfloat16)
    b, c = bc[..., :64], bc[..., 80:144]
    got = KS.ssd_scan(x, b, c, a, chunk=128)
    assert _crel(got.float(), KS.ssd_scan_plain(x, b, c, a, chunk=128).float()) \
        <= BF16_TOL
    with pytest.raises(ValueError, match="16-byte"):
        KS.ssd_scan(x, bc[..., 4:68], c, a, chunk=128)


@pytest.mark.cuda
def test_ssd_auto_runs_the_bf16_mamba2_state_on_the_kernel(cuda):
    """bf16 N = 128 at chunk 128 (mamba2-2.7b's state) fits the
    chunk-parallel kernels: ``auto`` sends it to the kernel."""
    from repro_torch.kernels import dispatch, ops
    x, b, c, a = _ssd(46, 2, 300, 64, 128, torch.bfloat16)
    assert KS.fits(64, 128, 128, torch.bfloat16)
    prev = dispatch.set_kernel_backend("auto")
    try:
        dispatch.reset_dispatch_stats()
        got = ops.ssd(x, b, c, a, chunk=128)
        st = dispatch.dispatch_stats()
    finally:
        dispatch.set_kernel_backend(prev)
    assert (st["kernel_ssd_calls"], st["dense_ssd_calls"]) == (1, 0)
    assert _crel(got.float(), KS.ssd_scan_plain(x, b, c, a, chunk=128).float()) \
        <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 128])
def test_ssd_scan_bf16_lies_well_inside_the_bf16_operand_witness(cuda, n):
    """The f32 contract, where it can be seen: the plain version with its
    three f32 operands rounded to bf16 (the witness) against the plain
    version.  The bf16 kernels keep those operands exact, so their gap
    must stay under a quarter of the witness's.  N = 128 runs
    ``ssd_chunk_kernel<4,8>``, mamba2-2.7b's state."""
    x, b, c, a = _ssd(47, 16, 1000, 64, n, torch.bfloat16)
    want = KS.ssd_scan_plain(x, b, c, a, chunk=128).float()
    got = KS.ssd_scan(x, b, c, a, chunk=128).float()
    witness = KS.ssd_scan_split_plain(x, b, c, a, chunk=128, pieces=1).float()
    assert _crel(got, want) <= 0.25 * _crel(witness, want)


@pytest.mark.cuda
def test_ssd_auto_routes_what_the_kernel_refuses_dense(cuda):
    """N = 128 at chunk 128 needs more shared memory than a block has:
    ``auto`` runs it dense without raising; forced ``kernel`` mode raises."""
    from repro_torch.kernels import dispatch, ops
    x, b, c, a = _ssd(45, 2, 256, 64, 128, torch.float32)
    assert not KS.fits(64, 128, 128) and KS.fits(64, 64, 128)
    prev = dispatch.set_kernel_backend("auto")
    try:
        dispatch.reset_dispatch_stats()
        got = ops.ssd(x, b, c, a, chunk=128)
        st = dispatch.dispatch_stats()
        assert (st["kernel_ssd_calls"], st["dense_ssd_calls"]) == (0, 1)
        dispatch.set_kernel_backend("kernel")
        with pytest.raises(ValueError, match="shared memory"):
            ops.ssd(x, b, c, a, chunk=128)
    finally:
        dispatch.set_kernel_backend(prev)
    assert _crel(got, KS.ssd_scan_plain(x, b, c, a, chunk=128)) <= F32_TOL


@pytest.mark.cuda
def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda):
    x, b, c, a = _ssd(40, 2, 64, 64, 128, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        KS.ssd_scan(x, b, c, a, chunk=128)
    with pytest.raises(ValueError, match="multiple of 16"):
        KS.ssd_scan(x, b, c, a, chunk=100)
    with pytest.raises(TypeError, match="float32"):
        KS.ssd_scan(x, b, c, a.bfloat16(), chunk=64)


# ---------------------------------------------------------------------------
# The served stacks on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch,flash,ssd", [("qwen3-4b", 2, 0),
                                            ("smollm-360m", 2, 0),
                                            ("mamba2-2.7b", 0, 2)])
def test_smoke_prefill_on_the_card_runs_the_kernels(cuda, arch, flash, ssd):
    """A smoke-size dense or ssm prefill in f32 launches one kernel per
    attention or Mamba2 layer and matches the plain prefill; a decode step
    after it launches none."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build
    cfg = dataclasses.replace(configs.get_smoke(arch), ssm_chunk=16,
                              param_dtype=torch.float32,
                              act_dtype=torch.float32)
    bundle = build(cfg)
    params = bundle.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=gen, device="cuda")
    prev = dispatch.set_kernel_backend("kernel")
    try:
        KF.flash_attention.launches = KS.ssd_scan.launches = 0
        with torch.no_grad():
            got, cache = T.prefill(params, cfg, tokens, 41,
                                   cache_dtype=torch.float32)
            assert (KF.flash_attention.launches, KS.ssd_scan.launches) == \
                (flash, ssd)
            bundle.serve_step(params, cache, tokens[:, -1:])
            assert (KF.flash_attention.launches, KS.ssd_scan.launches) == \
                (flash, ssd)
        dispatch.set_kernel_backend("dense")
        with torch.no_grad():
            want, _ = T.prefill(params, cfg, tokens, 41,
                                cache_dtype=torch.float32)
    finally:
        dispatch.set_kernel_backend(prev)
    assert _crel(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("sites", [[0, 1], [4, 1]])
def test_full_update_bond_in_kernel_mode_matches_dense(cuda, sites):
    """One complex64 full-update bond of a 2x3 D=2 state on the same cached
    environments: kernel mode (every Gram and tall-apply on the kernels)
    against dense mode, as the statevector and the bond fidelity."""
    from repro_torch.core import full_update as FU
    from repro_torch.core import gates
    from repro_torch.core.environments import row_environments
    from repro_torch.core.keys import TorchKey
    from repro_torch.core.peps import FullUpdate, apply_operator, \
        random_peps, to_statevector
    from repro_torch.kernels import dispatch

    gen = torch.Generator(device="cuda").manual_seed(2)
    state = random_peps(2, 3, 2, gen, dtype=torch.complex64, device=cuda)
    update = FullUpdate(rank=2, chi=8, als_eps=1e-6)
    envs = row_environments(state, FU.env_option(update), TorchKey(3))
    g = gates.trotter_gate(gates.pauli_term("ZZ") - 0.5 * gates.pauli_term("XX"),
                           0.2)
    out = {}
    for mode in ("kernel", "dense"):
        prev = dispatch.set_kernel_backend(mode)
        before = (KG.gram_complex.launches, KM.tall_apply_complex.launches)
        try:
            FU.drain_fidelities()
            new = apply_operator(state, g, sites, update, key=TorchKey(4),
                                 envs=envs)
            out[mode] = (to_statevector(new), FU.drain_fidelities())
        finally:
            dispatch.set_kernel_backend(prev)
        launched = (KG.gram_complex.launches - before[0],
                    KM.tall_apply_complex.launches - before[1])
        assert launched == ((2, 2) if mode == "kernel" else (0, 0))
    (vk, (fk,)), (vd, (fd,)) = out["kernel"], out["dense"]
    assert _crel(vk, vd) <= 1e-4
    assert abs(fk - fd) <= 1e-5 and 0.9 <= fk <= 1.0 + 1e-6


# ---------------------------------------------------------- zip-up sites --
# (site, D, g): the main path's D = 6, g = 36, then ragged shapes; p = 2,
# and u = U = 2 in the pair merge
ZIPUP_SHAPES = [("onelayer", 6, 36), ("twolayer", 6, 36), ("pair", 6, 0),
                ("onelayer", 2, 1), ("onelayer", 3, 7), ("onelayer", 8, 128),
                ("twolayer", 2, 1), ("twolayer", 3, 7), ("twolayer", 4, 36),
                ("twolayer", 8, 128), ("pair", 2, 0), ("pair", 3, 0),
                ("pair", 4, 0), ("pair", 8, 0)]
ZIPUP_SITES = {
    "onelayer": (KZ._first_onelayer_kernel, KZ.first_onelayer_plain,
                 "zipup_pair"),
    "twolayer": (KZ._first_twolayer_kernel, KZ.first_twolayer_plain,
                 "zipup_chain"),
    "pair": (KZ._pair_merge_kernel, KZ.pair_merge_plain, "zipup_pair"),
}


def _zipup_operands(seed, site, d, g, dtype=torch.complex64, dyadic=False):
    """The site's operands on the card: normals, or with ``dyadic`` parts
    k / 128, |k| <= 255 (bf16 values whose stage-1 sums are exact in f32)."""
    shapes = {"onelayer": [(1, d, g), (d, 1, d, d)],
              "twolayer": [(1, d, d, g), (2, d, 1, d, d), (2, d, 1, d, d)],
              "pair": [(2, 2, d, d, d), (2, 2, d, d, d)]}[site]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def part(shape):
        if dyadic:
            return torch.randint(-255, 256, shape, generator=gen,
                                 device="cuda").float() / 128
        return torch.randn(shape, generator=gen, device="cuda")
    if dtype == torch.complex64:
        return [torch.complex(part(s), part(s)) for s in shapes]
    return [part(s) for s in shapes]


def _zipup_call(site, xs, compute):
    from repro_torch.kernels import dispatch
    prev = dispatch.set_kernel_compute(compute)
    try:
        return ZIPUP_SITES[site][0](*xs)
    finally:
        dispatch.set_kernel_compute(prev)


def _t1_flip_tol(xs):
    """bf16 two-layer on normal inputs: a t1 entry within a sum-order
    rounding of a bf16 tie rounds the other way (2^-8 of that entry); four
    such flips of average entries (``tests/test_torch_zipup_block.py``)."""
    b, f, F, g = xs[0].shape
    p, _, c, h, k = xs[1].shape
    return max(F32_TOL, 2.0 ** -8 * (4.0 / (b * F * g * p * c * h * k)) ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("site,d,g", ZIPUP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_zipup_kernel_matches_plain(cuda, site, d, g, dtype, compute):
    """Each zip-up site on the card: one launch of its kernel, a contiguous
    output in the final order, the plain version's values, and a bit for
    bit repeat."""
    xs = _zipup_operands(70 + d, site, d, g, dtype)
    kernel = ZIPUP_SITES[site][2]
    before = KZ.kernel_launches()
    before_ta = KM.tall_apply_complex.launches
    got = _zipup_call(site, xs, compute)
    after = KZ.kernel_launches()
    assert after[kernel] == before[kernel] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert KM.tall_apply_complex.launches == before_ta
    want = ZIPUP_SITES[site][1](*xs, compute)
    assert got.is_contiguous() and got.dtype == dtype
    assert got.shape == want.shape
    tol = _t1_flip_tol(xs) if site == "twolayer" and compute else F32_TOL
    assert _crel(got, want) <= tol
    assert torch.equal(_zipup_call(site, xs, compute), got)


@pytest.mark.cuda
@pytest.mark.parametrize("d,g", [(3, 7), (6, 36), (8, 128)])
def test_zipup_chain_rounds_t1_where_the_plain_version_does(cuda, d, g):
    """bf16 multiplicands on dyadic operands, where t1 is exact in f32:
    the kernel's t1 rounding matches the plain version's to F32_TOL, and
    the witness that skips it misses by more than ten times that."""
    xs = _zipup_operands(80 + d, "twolayer", d, g, dyadic=True)
    got = _zipup_call("twolayer", xs, "bfloat16")
    want = KZ.first_twolayer_plain(*xs, "bfloat16")
    assert _crel(got, want) <= F32_TOL
    witness = torch.einsum("bfFg,pfchk,pFCHK->bcChHgkK", *xs)
    assert _crel(witness, want) > 10 * F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["onelayer", "twolayer", "pair"])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_zipup_kernels_read_conj_and_strided_views_in_place(cuda, site,
                                                            compute):
    """A conj view of the bra, a permuted S0 and a sliced ket, read in
    place: the call allocates its output and nothing else."""
    xs = _zipup_operands(90, site, 6, 36)
    if site == "onelayer":
        xs[0] = xs[0].permute(0, 2, 1).contiguous().permute(0, 2, 1)
    else:
        bra = 0 if site == "pair" else 1
        xs[bra] = xs[bra].conj()
        if site == "twolayer":
            xs[0] = xs[0].permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
        wide = torch.zeros(xs[-1].shape[:-1] + (2 * xs[-1].shape[-1],),
                           dtype=xs[-1].dtype, device=cuda)
        wide[..., ::2] = xs[-1]
        xs[-1] = wide[..., ::2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = _zipup_call(site, xs, compute)
    torch.cuda.synchronize()
    # the caching allocator rounds a block up to 512 bytes
    assert torch.cuda.max_memory_allocated() - base == \
        -(-got.numel() * 8 // 512) * 512
    want = ZIPUP_SITES[site][1](*xs, compute)
    tol = _t1_flip_tol(xs) if site == "twolayer" and compute else F32_TOL
    assert _crel(got, want) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["onelayer", "twolayer", "pair"])
def test_zipup_kernels_refuse_double_precision(cuda, site):
    xs = [x.to(torch.complex128) for x in _zipup_operands(95, site, 3, 7)]
    with pytest.raises(TypeError, match="complex64"):
        ZIPUP_SITES[site][0](*xs)


@pytest.mark.cuda
@pytest.mark.parametrize("twolayer", [False, True])
def test_zipup_engine_reshape_after_the_site_is_a_view(cuda, twolayer):
    """The first column of a zip-up in kernel mode: the site's output is
    contiguous and the carry the engine makes of it shares its storage."""
    from repro_torch.core.einsumsvd import DirectSVD
    from repro_torch.core.engines import zipup as ZE
    from repro_torch.kernels import dispatch

    name = "zipup_first_twolayer" if twolayer else "zipup_first_onelayer"
    site, seen = dispatch.site(name), []

    def recording(*args):
        seen.append(site.kernel_fn(*args))
        return seen[-1]

    prev = dispatch.set_kernel_backend("kernel")
    dispatch.register_kernel(name, kernel=recording, dense=site.dense_fn,
                             supported=site.supported, auto=site.auto)
    try:
        if twolayer:
            s0, bra, ket = _zipup_operands(96, "twolayer", 6, 36)
            _, carry = ZE.zipup_block_twolayer(None, [s0], [bra], [ket], 8,
                                               DirectSVD(), [None],
                                               first=True, last=False)
        else:
            s0, o0 = _zipup_operands(97, "onelayer", 6, 36)
            _, carry = ZE.zipup_block(None, [s0], [o0], 8, DirectSVD(),
                                      [None], first=True, last=False)
    finally:
        dispatch.register_kernel(name, kernel=site.kernel_fn,
                                 dense=site.dense_fn,
                                 supported=site.supported, auto=site.auto)
        dispatch.set_kernel_backend(prev)
    assert len(seen) == 1 and seen[0].is_contiguous()
    assert carry.data_ptr() == seen[0].data_ptr()


# ------------------------------------------------- device not current ----

@pytest.fixture
def last_cuda(cuda):
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs 2 or more CUDA devices (a launch on a device "
                    "that is not the current one)")
    return torch.device("cuda", count - 1)


def _peps_kernel_call(kernel, dev):
    """(launch, plain version, launch counter) of one PEPS kernel at its
    main-path shape, the operands on ``dev``."""
    if kernel == "gram_complex":
        a = _c64(110, 82944, 72).to(dev)
        return (lambda: KG.gram_complex(a),
                lambda: KG.gram_complex_plain(a),
                lambda: KG.gram_complex.launches)
    if kernel == "tall_apply_complex":
        a, b = _c64(112, 82944, 72).to(dev), _c64(114, 72, 72).to(dev)
        return (lambda: KM.tall_apply_complex(a, b),
                lambda: KM.tall_apply_complex_plain(a, b),
                lambda: KM.tall_apply_complex.launches)
    site = {"zipup_pair": "onelayer", "zipup_chain": "twolayer",
            "pair_merge": "pair"}[kernel]
    xs = [x.to(dev) for x in _zipup_operands(116, site, 6, 36)]
    fn, plain, counter = ZIPUP_SITES[site]
    return (lambda: fn(*xs), lambda: plain(*xs),
            lambda: KZ.kernel_launches()[counter])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gram_complex", "tall_apply_complex",
                                    "zipup_pair", "zipup_chain",
                                    "pair_merge"])
def test_peps_kernel_launches_on_a_device_that_is_not_current(last_cuda,
                                                              kernel):
    """With cuda:0 current, each PEPS kernel on operands of the last card
    launches there (one launch, in that card's stream), matches its plain
    version, repeats bit for bit, and leaves cuda:0 current."""
    with torch.cuda.device(0):
        launch, plain, launches = _peps_kernel_call(kernel, last_cuda)
        before = launches()
        got = launch()
        torch.cuda.synchronize(last_cuda)
        assert launches() == before + 1
        assert torch.cuda.current_device() == 0
        assert got.device == last_cuda
        assert _crel(got, plain()) <= F32_TOL
        assert torch.equal(launch(), got)


@pytest.mark.cuda
def test_peps_kernels_from_two_threads_on_two_streams(cuda):
    """Two threads, each with its own stream on one card (as the workers of
    ``repro_torch.core.spmd`` run), launch ``gram_complex``,
    ``tall_apply_complex`` and ``zipup_chain`` at once, many times: every
    result equals its plain version and the same call made from one
    thread bit for bit, and every launch is counted."""
    import threading

    calls = {k: _peps_kernel_call(k, cuda)
             for k in ("gram_complex", "tall_apply_complex", "zipup_chain")}
    single = {k: launch() for k, (launch, _, _) in calls.items()}
    torch.cuda.synchronize()
    for k, (_, plain, _) in calls.items():
        assert _crel(single[k], plain()) <= F32_TOL, k
    before = {k: launches() for k, (_, _, launches) in calls.items()}
    reps = 20
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def work(t):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.device(cuda), torch.cuda.stream(stream):
                barrier.wait(timeout=60)
                out = {k: [launch() for _ in range(reps)]
                       for k, (launch, _, _) in calls.items()}
                stream.synchronize()
            results[t] = out
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    for k, (_, _, launches) in calls.items():
        assert launches() == before[k] + 2 * reps, k
        assert all(torch.equal(got, single[k])
                   for t in range(2) for got in results[t][k]), k
