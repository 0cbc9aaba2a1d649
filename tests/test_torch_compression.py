"""The port's int8 error-feedback compression
(``repro_torch.optim.compression``) against the reference's, on the CPU.

``quantize``, ``dequantize`` and ``compress_residual`` take the same numpy
inputs as the JAX functions: the int8 payloads equal, the scales and
residuals within f32 rounding.  ``psum_compressed`` over ranks, and the
compressed train step, are held in ``tests/test_torch_lm_compressed.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")


from repro.optim import compression as RCMP  # noqa: E402
from repro_torch.optim import compression as CMP  # noqa: E402

F32_EPS = float(np.finfo(np.float32).eps)


def _inputs(kind):
    rng = np.random.default_rng(11)
    g = rng.standard_normal((37, 29)).astype(np.float32)
    err = (1e-3 * rng.standard_normal((37, 29))).astype(np.float32)
    if kind == "zeros":
        return np.zeros_like(g), np.zeros_like(err)
    if kind == "tiny":
        return 1e-9 * g, 1e-12 * err
    if kind == "halves":      # exact halves: round half to even in both
        return (np.arange(-40, 40, dtype=np.float32) / 2 * 127 / 20,
                np.zeros(80, np.float32))
    return g, err


KINDS = ["normal", "zeros", "tiny", "halves"]


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_matches_reference(kind):
    g, _ = _inputs(kind)
    q, scale = CMP.quantize(torch.from_numpy(g))
    rq, rscale = RCMP.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(scale), float(rscale), rtol=F32_EPS)
    np.testing.assert_allclose(
        CMP.dequantize(q, scale).numpy(),
        np.asarray(RCMP.dequantize(rq, rscale)),
        rtol=F32_EPS, atol=F32_EPS * float(rscale))


@pytest.mark.parametrize("kind", KINDS)
def test_compress_residual_matches_reference(kind):
    g, err = _inputs(kind)
    q, scale, new = CMP.compress_residual(torch.from_numpy(g),
                                          torch.from_numpy(err))
    rq, rscale, rnew = RCMP.compress_residual(jnp.asarray(g),
                                              jnp.asarray(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(scale), float(rscale), rtol=F32_EPS)
    # the residual is at most half a quantum; f32 rounding of it
    np.testing.assert_allclose(new.numpy(), np.asarray(rnew), rtol=0,
                               atol=2 * F32_EPS * max(float(rscale), 1e-30))


def test_init_error_state_is_zero_f32():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16),
            "b": {"c": torch.ones(2)}}
    err = CMP.init_error_state(tree)
    assert err["a"].dtype == err["b"]["c"].dtype == torch.float32
    assert not err["a"].any() and not err["b"]["c"].any()
