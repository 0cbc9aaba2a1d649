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
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

# f32: the same f32 products and exponentials summed in another order.
F32_TOL = 1e-5
# bf16 operands: Q * 1/sqrt(D) is rounded to bf16 before the product here
# and in the Pallas kernel but not in ref.attention, and the output is
# rounded to bf16 (relative step 2^-8).
BF16_TOL = 2e-2
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
