"""The plain versions of the LM kernels against the reference, on the CPU.

``flash_attention_plain`` and ``ssd_scan_plain`` are what the wrappers run
for CPU tensors.  They are held against the reference's Pallas kernels in
interpret mode and against its oracles (``repro.kernels.ref``), on inputs
drawn with numpy.  The CUDA kernels are held against these plain versions
on the card in ``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as rflash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as rssd  # noqa: E402
from repro.models.attention import _sdpa as rsdpa  # noqa: E402
from repro.models.ssm import ssd_chunked as rssd_chunked  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain, flash_attention_split_plain,
    lo_piece_probe, split_bf16x3)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan, ssd_scan_plain, ssd_scan_split_plain)
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

# f32: the same f32 products and exponentials summed in another order.
F32_TOL = 1e-5
# bf16 operands: Q * 1/sqrt(D) is rounded to bf16 before the product here
# and in the Pallas kernel but not in ref.attention, and the output is
# rounded to bf16 (relative step 2^-8).
BF16_TOL = 2e-2
# P V as three bf16 products of the exact split of P against P V in f32:
# the same sums in another order, about 2e-7; with two pieces (P to 16
# bits) about 2.5e-6.
SPLIT3_TOL = 1e-6
# ``lo_piece_probe``'s column against its exact value: about 1e-2 with all
# three pieces, about 0.6 without lo.
PROBE_TOL = 0.1
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _pair(x, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(x).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(_JNP[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_plain_matches_pallas_and_oracle(causal, d, dtype):
    """GQA (4 query heads over 2 KV heads) at a ragged S = 100."""
    b, hq, hkv, s = 1, 4, 2, 100
    q, qj = _pair(_rand(0, b, hq, s, d), dtype)
    k, kj = _pair(_rand(1, b, hkv, s, d), dtype)
    v, vj = _pair(_rand(2, b, hkv, s, d), dtype)
    got = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == (b, hq, s, d) and got.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    pallas = rflash(qj, kj, vj, causal=causal, bq=64, bk=64, interpret=True)
    oracle = ref.attention(qj, kj, vj, causal=causal)
    assert _rel(got.float(), np.asarray(pallas, np.float32)) <= tol
    assert _rel(got.float(), np.asarray(oracle, np.float32)) <= tol


def _softmax_values(kind):
    """f32 values the bf16 kernel splits: softmax rows of random logits at
    two spreads (the wide one reaches far below 1e-30), or edge values."""
    if kind == "edges":
        return torch.tensor([0.0, 1.0, 0.5, 1.0 - 2.0 ** -24, 1e-30, 3e-30,
                             2.0 ** -126, 1e-38, 1e-40, 1e-45, 2.0 ** -100,
                             0.1, 1.0 / 3.0], dtype=torch.float32)
    spread = {"narrow": 1.0, "wide": 40.0}[kind]
    logits = torch.from_numpy(_rand(20, 64, 512, scale=spread))
    return torch.softmax(logits, dim=-1)


@pytest.mark.parametrize("kind", ["narrow", "wide", "edges"])
def test_split_bf16x3_rebuilds_f32_softmax_values(kind):
    """hi + mid + lo is p bit for bit for p >= 1e-30; below, bf16's
    subnormals cost lo some bits, an absolute error under 1e-38."""
    p = _softmax_values(kind)
    pieces = split_bf16x3(p)
    assert all(x.dtype == torch.bfloat16 for x in pieces)
    hi, mid, lo = (x.float() for x in pieces)
    back = (hi + mid) + lo
    big = p >= 1e-30
    assert torch.equal(back[big], p[big])
    assert ((back - p).abs() < 1e-38)[~big].all()
    assert torch.equal(hi, p.to(torch.bfloat16).float())


def _bf16_valued(seed, *shape):
    """Random values representable in bf16, held in f32: the kernel's bf16
    operands, seen by an f32 computation."""
    return torch.from_numpy(_rand(seed, *shape)).to(torch.bfloat16).float()


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_with_p_split_in_three_matches_pallas_and_plain(causal, d):
    """P V as three bf16 products of the exact split of P, accumulated in
    f32 (the bf16 kernel's arithmetic), against the Pallas kernel in
    interpret mode and the plain version (P V in f32), GQA 4:2 at a ragged
    S = 100."""
    b, hq, hkv, s = 1, 4, 2, 100
    q, k, v = (_bf16_valued(30 + i, b, h, s, d)
               for i, h in enumerate((hq, hkv, hkv)))
    got = flash_attention_split_plain(q, k, v, causal=causal, pieces=3)
    pallas = rflash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                    causal=causal, bq=64, bk=64, interpret=True)
    assert _rel(got, np.asarray(pallas)) <= F32_TOL
    assert _rel(got, flash_attention_plain(q, k, v, causal=causal)) <= F32_TOL
    assert _rel(got, flash_attention_plain(q, k, v, causal=causal)) \
        <= SPLIT3_TOL


def test_flash_with_p_rounded_to_bf16_misses_the_f32_tolerance():
    """The witness: the same computation with P rounded to bf16 (one piece)
    lies beyond F32_TOL from the plain version, so the test above can tell
    an exact P from a rounded one."""
    b, hq, hkv, s, d = 1, 4, 2, 100, 80
    q, k, v = (_bf16_valued(30 + i, b, h, s, d)
               for i, h in enumerate((hq, hkv, hkv)))
    want = flash_attention_plain(q, k, v, causal=True)
    assert _rel(flash_attention_split_plain(q, k, v, causal=True, pieces=1),
                want) > F32_TOL


@pytest.mark.parametrize("d", [16, 80])
def test_flash_with_p_in_two_pieces_misses_the_split_tolerance(d):
    """Without lo, P keeps 16 bits: the gap to the plain version lies
    beyond SPLIT3_TOL, so the three-piece test can tell two pieces from
    three."""
    b, hq, hkv, s = 1, 4, 2, 100
    q, k, v = (_bf16_valued(30 + i, b, h, s, d)
               for i, h in enumerate((hq, hkv, hkv)))
    want = flash_attention_plain(q, k, v, causal=True)
    assert _rel(flash_attention_split_plain(q, k, v, causal=True, pieces=2),
                want) > SPLIT3_TOL


@pytest.mark.parametrize("pieces", [2, 3])
def test_lo_piece_probe_tells_three_pieces_from_two(pieces):
    """The probe the card holds the bf16 kernel to: its column is exact to
    PROBE_TOL only when lo is in the sum."""
    q, k, v, want = lo_piece_probe("cpu")
    assert all(t.dtype == torch.bfloat16 for t in (q, k, v))
    got = flash_attention_split_plain(q, k, v, causal=False, pieces=pieces)
    assert (_rel(got[0, 0, :, 0].double(), want) <= PROBE_TOL) \
        == (pieces == 3)
    # the plain version (P V in f32) is the three-piece sum's reference
    plain = flash_attention_plain(q, k, v, causal=False)[0, 0, :, 0]
    assert _rel(plain.double(), want) <= PROBE_TOL


def test_flash_plain_cross_attention_with_fewer_keys():
    """Non-causal, 75 keys for 100 queries (keys masked past Sk)."""
    q, qj = _pair(_rand(3, 1, 2, 100, 32), torch.float32)
    k, kj = _pair(_rand(4, 1, 2, 75, 32), torch.float32)
    v, vj = _pair(_rand(5, 1, 2, 75, 32), torch.float32)
    got = flash_attention_plain(q, k, v, causal=False)
    assert _rel(got, ref.attention(qj, kj, vj, causal=False)) <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_plain_with_kv_len_matches_reference_sdpa(dtype):
    """The decode form: one query per sequence against a 50-slot cache of
    which the first 17 and 41 keys are valid, GQA 4:2, D = 80, held against
    the reference model's ``_sdpa`` (which scales the f32 scores instead of
    Q, hence the bf16 tolerance in bf16)."""
    b, hq, hkv, sk, d = 2, 4, 2, 50, 80
    q, qj = _pair(_rand(14, b, hq, 1, d), dtype)
    k, kj = _pair(_rand(15, b, hkv, sk, d), dtype)
    v, vj = _pair(_rand(16, b, hkv, sk, d), dtype)
    kv_len = np.array([17, 41], np.int32)
    got = flash_attention_plain(q, k, v, causal=False,
                                kv_len=torch.from_numpy(kv_len))
    assert got.shape == (b, hq, 1, d) and got.dtype == dtype
    want = rsdpa(*(jnp.swapaxes(t, 1, 2) for t in (qj, kj, vj)), causal=False,
                 kv_len=jnp.asarray(kv_len))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(got.float().transpose(1, 2),
                np.asarray(want, np.float32)) <= tol


def _ssd_inputs(seed, bh, length, p, n):
    x = _rand(seed, bh, length, p)
    b = _rand(seed + 1, bh, length, n, scale=0.5)
    c = _rand(seed + 2, bh, length, n, scale=0.5)
    a = -np.abs(_rand(seed + 3, bh, length)) * 0.1       # log-decay <= 0
    return x, b, c, a


@pytest.mark.parametrize("bh,length,p,n,chunk", [(3, 200, 16, 16, 64),
                                                 (2, 200, 64, 64, 64),
                                                 (2, 40, 16, 16, 16)])
def test_ssd_plain_matches_pallas_and_oracle(bh, length, p, n, chunk):
    """A ragged last chunk in every case (200 = 3 x 64 + 8, 40 = 2 x 16 + 8)."""
    x, b, c, a = _ssd_inputs(7, bh, length, p, n)
    got = ssd_scan_plain(*map(torch.from_numpy, (x, b, c, a)), chunk=chunk)
    assert got.shape == (bh, length, p) and got.dtype == torch.float32
    pallas = rssd(*map(jnp.asarray, (x, b, c, a)), chunk=chunk, interpret=True)
    oracle = ref.ssd(*map(jnp.asarray, (x, b, c, a)))
    assert _rel(got, pallas) <= F32_TOL
    assert _rel(got, oracle) <= F32_TOL


def _ssd_bf16_valued(seed, bh, length, p, n):
    """``_ssd_inputs`` with x, B and C rounded to bf16 values (held in f32):
    the bf16 kernels' operands, seen by an f32 computation."""
    x, b, c, a = (torch.from_numpy(t) for t in _ssd_inputs(seed, bh, length,
                                                            p, n))
    return (*(t.to(torch.bfloat16).float() for t in (x, b, c)), a)


@pytest.mark.parametrize("bh,length,p,n,chunk", [(3, 200, 16, 16, 64),
                                                 (2, 256, 64, 64, 128)])
def test_ssd_with_operands_split_in_three_matches_pallas_and_plain(
        bh, length, p, n, chunk):
    """The three products with an f32 operand (decayed scores, decay-
    weighted B, incoming state) as three bf16 products of its exact split
    (the bf16 kernels' arithmetic), y and the final state, against the
    Pallas kernel in interpret mode and the plain version; 200 = 3 x 64 + 8
    ends in a ragged chunk."""
    x, b, c, a = _ssd_bf16_valued(40, bh, length, p, n)
    y, h = ssd_scan_split_plain(x, b, c, a, chunk=chunk, return_state=True,
                                pieces=3)
    y0, h0 = ssd_scan_plain(x, b, c, a, chunk=chunk, return_state=True)
    pallas = rssd(*(jnp.asarray(t.numpy()) for t in (x, b, c, a)),
                  chunk=chunk, interpret=True)
    assert y.shape == (bh, length, p) and h.shape == (bh, n, p)
    assert _rel(y, np.asarray(pallas)) <= F32_TOL
    assert _rel(y, y0) <= F32_TOL
    assert _rel(h, h0) <= F32_TOL


@pytest.mark.parametrize("bh,length,p,n,chunk", [(3, 200, 16, 16, 64),
                                                 (2, 256, 64, 64, 128)])
def test_ssd_with_operands_rounded_to_bf16_misses_the_f32_tolerance(
        bh, length, p, n, chunk):
    """The witness: the same computation with the three f32 operands
    rounded to bf16 (one piece) lies beyond F32_TOL from the plain
    version, so the test above can tell exact operands from rounded
    ones."""
    x, b, c, a = _ssd_bf16_valued(40, bh, length, p, n)
    want = ssd_scan_plain(x, b, c, a, chunk=chunk)
    assert _rel(ssd_scan_split_plain(x, b, c, a, chunk=chunk, pieces=1),
                want) > F32_TOL


def test_ssd_chunked_final_state_matches_reference():
    """The port's ssd_chunked ((B, H, L, P) layout over ssd_scan_plain)
    against the reference model's, y and the final (N, P) state."""
    shape = (2, 3, 200)
    x, b, c, a = _ssd_inputs(8, 6, 200, 16, 16)
    x, b, c = (t.reshape(*shape, -1) for t in (x, b, c))
    a = a.reshape(shape)
    y, state = ssd_chunked(*map(torch.from_numpy, (x, b, c, a)), chunk=64,
                           return_state=True)
    y_ref, state_ref = rssd_chunked(*map(jnp.asarray, (x, b, c, a)),
                                    chunk=64, return_state=True)
    assert state.shape == (2, 3, 16, 16) and state.dtype == torch.float32
    assert _rel(state, state_ref) <= F32_TOL
    assert _rel(y, y_ref) <= F32_TOL


def test_ssd_plain_final_state_continues_the_sequence():
    """Scanning [0, 120) then [120, 200) from the returned state (the
    prefill -> decode contract, as the one-step recurrence) gives the
    full scan's last outputs."""
    x, b, c, a = map(torch.from_numpy, _ssd_inputs(9, 2, 200, 16, 16))
    full = ssd_scan_plain(x, b, c, a, chunk=64)
    _, h = ssd_scan_plain(x[:, :120], b[:, :120], c[:, :120], a[:, :120],
                          chunk=64, return_state=True)
    for t in range(120, 200):
        h = torch.exp(a[:, t])[:, None, None] * h + \
            b[:, t, :, None] * x[:, t, None, :]
        assert _rel(torch.einsum("zn,znp->zp", c[:, t], h), full[:, t]) \
            <= F32_TOL


def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    q = torch.from_numpy(_rand(10, 1, 2, 20, 16))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, q, q, causal=True),
                               flash_attention_plain(q, q, q, causal=True),
                               rtol=0, atol=0)
    x, b, c, a = map(torch.from_numpy, _ssd_inputs(11, 2, 40, 16, 16))
    y, st = ssd_scan(x, b, c, a, chunk=16, return_state=True)
    y0, st0 = ssd_scan_plain(x, b, c, a, chunk=16, return_state=True)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert flash_attention.launches == before     # no kernel on the CPU


def test_ops_sites_count_and_gate():
    """``attention`` and ``ssd`` are dispatch sites: kernel calls are
    counted, f64 never reaches a kernel, ``auto`` on a CPU operand stays
    dense."""
    q = torch.from_numpy(_rand(12, 1, 2, 20, 16))
    x, b, c, a = map(torch.from_numpy, _ssd_inputs(13, 2, 40, 16, 16))
    dispatch.reset_dispatch_stats()
    prev = dispatch.set_kernel_backend("kernel")
    try:
        ops.attention(q, q, q)
        ops.ssd(x, b, c, a, chunk=16)
        ops.attention(q.double(), q.double(), q.double())
    finally:
        dispatch.set_kernel_backend(prev)
    dispatch.set_kernel_backend("auto")
    try:
        ops.ssd(x, b, c, a, chunk=16)
    finally:
        dispatch.set_kernel_backend(prev)
    st = dispatch.dispatch_stats()
    assert (st["kernel_attention_calls"], st["dense_attention_calls"]) == (1, 1)
    assert (st["kernel_ssd_calls"], st["dense_ssd_calls"]) == (1, 1)


class _SmemQuery:
    """Stands in for the kernel library: ``repro_ssd_scan_smem_bytes`` as
    ``csrc/ssd_scan.cu`` computes it, so that no ``nvcc`` is needed."""

    @staticmethod
    def repro_ssd_scan_smem_bytes(p, n, chunk):
        ldt = chunk + 1
        return 4 * (2 * n * ldt + chunk * ldt + chunk * p + n * p + 3 * chunk)

    @staticmethod
    def repro_ssd_chunked_smem_bytes(p, n, chunk):
        """A block of the bf16 kernel, ``ssd_chunk_kernel``: C, B and x
        tiles and three bf16 pieces of h_in, rows padded by 8, h_in in f32
        (rows padded by 8), and the chunk's prefix sums and weights; P and
        N padded to 16, 32, 64 or 128."""
        def padded(v):
            t = 16
            while t < v:
                t *= 2
            return t

        pp, np_ = padded(p), padded(n)
        ldb, ldx = np_ + 8, pp + 8
        return 2 * (2 * chunk * ldb + chunk * ldx + 3 * np_ * ldx) \
            + 4 * (np_ * ldx + 2 * chunk)


@pytest.mark.parametrize("p,n,chunk,takes", [
    (64, 64, 128, True),       # Zamba2's state: 182,784 bytes
    (64, 128, 128, False),     # mamba2's state at chunk 128: 265,216 bytes
    (64, 128, 64, True),       # the same state at chunk 64
    (80, 64, 128, False),      # P above MAX_HEAD_DIM
    (64, 64, 100, False),      # chunk not a multiple of 16
])
def test_ssd_fits_asks_the_library_size_query(monkeypatch, p, n, chunk,
                                              takes):
    """``fits`` applies the wrapper's limits and the library's own
    shared-memory query against one block's limit: the ``ssd`` site's
    ``auto`` mode sends what it refuses to the dense form."""
    from repro_torch.kernels import build, ssd_scan as KS
    assert _SmemQuery.repro_ssd_scan_smem_bytes(64, 128, 128) == 265216
    monkeypatch.setattr(build, "library", lambda: _SmemQuery)
    assert KS.fits(p, n, chunk) is takes


@pytest.mark.parametrize("p,n,chunk,dtype,takes", [
    (64, 128, 128, torch.bfloat16, True),    # mamba2's state: 181,248 bytes
    (64, 128, 128, torch.float32, False),    # the f32 kernel: 265,216 bytes
    (64, 64, 128, torch.bfloat16, True),     # Zamba2's state
    (64, 120, 128, torch.bfloat16, True),    # N padded to 128 in the tiles
    (64, 20, 64, torch.bfloat16, False),     # N not a multiple of 8
    (80, 64, 128, torch.bfloat16, False),    # P above MAX_HEAD_DIM
])
def test_ssd_fits_is_dtype_aware(monkeypatch, p, n, chunk, dtype, takes):
    """bf16 asks the chunk-parallel kernels' size query, which takes
    mamba2-2.7b's N = 128 at chunk 128; f32 keeps the one-block-per-series
    kernel's limit, so there the ``auto`` mode still runs it dense."""
    from repro_torch.kernels import build, ssd_scan as KS
    assert _SmemQuery.repro_ssd_chunked_smem_bytes(64, 128, 128) == 181248
    monkeypatch.setattr(build, "library", lambda: _SmemQuery)
    assert KS.fits(p, n, chunk, dtype) is takes
