"""The port's regularized factorization derivatives against the reference.

``repro_torch.core.svd_grad`` writes each rule twice: ``jvp`` is the
reference's JVP, ``backward`` its adjoint.  For every wrapper, on random
real and complex inputs from a numpy seed:

* the forward equals the plain ``torch.linalg`` call bit for bit;
* the adjoint identity ``Re <VJP(c), dA> = Re <c, JVP(dA)>`` holds within
  1e-12 relative, both sides through torch's own machinery
  (``torch.autograd.grad`` and forward-mode dual tensors);
* the JVP equals ``jax.jvp`` of the reference wrapper within 1e-10 on
  gauge-invariant outputs (the two LAPACKs pick different phases): the
  spectrum, the truncated product ``u diag(s) vh``, ``q r`` and projectors.

Then the reference's degenerate and rank-deficient cases
(``tests/test_vqe_grad.py``) give finite gradients, and ``sqrt_reg`` has
derivative 0 at 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.autograd.forward_ad as fwAD  # noqa: E402

from repro.core import svd_grad as R  # noqa: E402
from repro.core.orthogonalize import gram_qr as r_gram_qr  # noqa: E402
from repro_torch.core import svd_grad as T  # noqa: E402
from repro_torch.core.orthogonalize import gram_qr  # noqa: E402

ADJOINT_RTOL = 1e-12
JVP_RTOL = 1e-10


def _rand(rng, shape, complex_):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if complex_ else x


def _re_inner(x, y) -> float:
    return float(np.real(np.vdot(np.asarray(x), np.asarray(y))))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _port_jvp(fn, a, da):
    """Primal outputs and tangents through torch's forward-mode AD."""
    with fwAD.dual_level():
        outs = _as_tuple(fn(fwAD.make_dual(torch.tensor(a), torch.tensor(da))))
        unpacked = [fwAD.unpack_dual(o) for o in outs]
    return ([u.primal.numpy() for u in unpacked],
            [u.tangent.numpy() for u in unpacked])


def _svd_gauge_free(outs, tans, k=2):
    (u, s, vh), (du, ds, dvh) = outs, tans
    d_prod = ((du[..., :k] * s[..., None, :k]) @ vh[..., :k, :]
              + (u[..., :k] * ds[..., None, :k]) @ vh[..., :k, :]
              + (u[..., :k] * s[..., None, :k]) @ dvh[..., :k, :])
    return [ds, d_prod]


def _eigh_gauge_free(outs, tans, k=2):
    (w, v), (dw, dv) = outs, tans
    vk, dvk = v[:, :k], dv[:, :k]
    return [dw, dvk @ vk.conj().T + vk @ dvk.conj().T]   # d(projector)


def _qr_gauge_free(outs, tans):
    (q, r), (dq, dr) = outs, tans
    out = [dq @ r + q @ dr]
    if q.shape[0] > q.shape[1]:                          # d(projector)
        out.append(dq @ q.conj().T + q @ dq.conj().T)
    return out


def _svd_input(rng, shape, complex_):
    return _rand(rng, shape, complex_)


def _eigh_input(rng, shape, complex_):
    x = _rand(rng, shape, complex_)
    return x + x.conj().T


def _sqrt_input(rng, shape, complex_):
    return np.abs(_rand(rng, shape, False)) + 0.1


WRAPPERS = {
    "svd": (T.svd_reg, R.svd_reg, _svd_input, _svd_gauge_free,
            lambda a: torch.linalg.svd(a, full_matrices=False)),
    "eigh": (T.eigh_reg, R.eigh_reg, _eigh_input, _eigh_gauge_free,
             torch.linalg.eigh),
    "qr": (T.qr_reg, R.qr_reg, _svd_input, _qr_gauge_free, torch.linalg.qr),
    "sqrt": (T.sqrt_reg, R.sqrt_reg, _sqrt_input, lambda o, t: t, torch.sqrt),
}

CASES = ([("svd", shape, c) for shape in [(7, 4), (4, 7), (5, 5), (3, 6, 4)]
          for c in (False, True)]
         + [("eigh", (6, 6), c) for c in (False, True)]
         + [("qr", shape, c) for shape in [(7, 4), (5, 5)]
            for c in (False, True)]
         + [("sqrt", (6,), False)])


def _case_id(case):
    name, shape, complex_ = case
    return f"{name}-{'x'.join(map(str, shape))}-{'c' if complex_ else 'r'}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forward_adjoint_and_jvp(case):
    name, shape, complex_ = case
    port, ref, make, gauge_free, plain = WRAPPERS[name]
    rng = np.random.default_rng(CASES.index(case))
    a = make(rng, shape, complex_)
    da = _rand(rng, shape, complex_)
    if name == "eigh":
        da = da + da.conj().T

    # forward: the plain torch.linalg call, bit for bit
    outs = _as_tuple(port(torch.tensor(a)))
    for got, want in zip(outs, _as_tuple(plain(torch.tensor(a)))):
        assert torch.equal(got, want)

    # adjoint identity, VJP by torch.autograd.grad, JVP by forward AD
    at = torch.tensor(a, requires_grad=True)
    outs = _as_tuple(port(at))
    cots = [torch.tensor(_rand(rng, o.shape, o.is_complex())) for o in outs]
    (ga,) = torch.autograd.grad(outs, at, cots)
    primals, tangents = _port_jvp(port, a, da)
    lhs = _re_inner(ga.numpy(), da)
    rhs = sum(_re_inner(c.numpy(), t) for c, t in zip(cots, tangents))
    assert abs(lhs - rhs) <= ADJOINT_RTOL * max(abs(rhs), 1e-300)

    # JVP against the reference's, on gauge-invariant outputs
    if len(shape) == 2 or name == "sqrt":
        rp, rt = jax.jvp(ref, (jnp.asarray(a),), (jnp.asarray(da),))
        rp = [np.asarray(x) for x in _as_tuple(rp)]
        rt = [np.asarray(x) for x in _as_tuple(rt)]
        for got, want in zip(gauge_free(primals, tangents),
                             gauge_free(rp, rt)):
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= JVP_RTOL, (name, err)


def test_batched_svd_matches_per_matrix():
    rng = np.random.default_rng(4)
    a = _rand(rng, (3, 6, 4), True)
    c = [torch.tensor(_rand(rng, s, cplx)) for s, cplx in
         (((3, 6, 4), True), ((3, 4), False), ((3, 4, 4), True))]
    at = torch.tensor(a, requires_grad=True)
    (ga,) = torch.autograd.grad(T.svd_reg(at), at, c)
    for i in range(3):
        ai = torch.tensor(a[i], requires_grad=True)
        (gi,) = torch.autograd.grad(T.svd_reg(ai), ai, [x[i] for x in c])
        np.testing.assert_allclose(ga[i].numpy(), gi.numpy(), atol=1e-13)


def test_real_loss_gradient_is_conjugate_of_jax_grad():
    """torch's convention: for a real loss of a complex input the gradient
    is the conjugate of ``jax.grad``'s."""
    rng = np.random.default_rng(5)
    a = _rand(rng, (6, 4), True)
    w = _rand(rng, (6, 4), True)

    def loss_ref(x):
        u, s, vh = R.svd_reg(x)
        return jnp.real(jnp.sum(jnp.asarray(w) * ((u[:, :2] * s[:2]) @ vh[:2])))

    at = torch.tensor(a, requires_grad=True)
    u, s, vh = T.svd_reg(at)
    loss = torch.sum(torch.tensor(w) * ((u[:, :2] * s[:2]) @ vh[:2])).real
    (g,) = torch.autograd.grad(loss, at)
    want = np.conj(np.asarray(jax.jit(jax.grad(loss_ref))(jnp.asarray(a))))
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-11)


@pytest.mark.parametrize("complex_", [False, True])
def test_gram_qr_gradient_matches_reference(complex_):
    """``gram_qr`` eigendecomposes G / max|G| where the reference takes G:
    the same eigenvectors and scaled eigenvalues, so the gradient differs
    by rounding only."""
    rng = np.random.default_rng(6)
    a = _rand(rng, (9, 2, 3), complex_)
    w = _rand(rng, (9, 2), complex_)

    def loss_ref(x):
        q, _ = r_gram_qr(x, 1)
        proj = jnp.einsum("abk,cdk->abcd", q, q.conj())
        return jnp.real(jnp.einsum("abcd,cd,ab->", proj, jnp.asarray(w),
                                   jnp.asarray(w).conj()))

    at = torch.tensor(a, requires_grad=True)
    q, _ = gram_qr(at, 1)
    proj = torch.einsum("abk,cdk->abcd", q, q.conj())
    wt = torch.tensor(w)
    loss = torch.einsum("abcd,cd,ab->", proj, wt, wt.conj()).real
    (g,) = torch.autograd.grad(loss, at)
    want = np.conj(np.asarray(jax.jit(jax.grad(loss_ref))(jnp.asarray(a))))
    assert np.linalg.norm(g.numpy() - want) <= 1e-12 * np.linalg.norm(want)


def test_svd_reg_degenerate_spectrum_finite():
    """Exactly repeated and exactly zero singular values: the regularized
    gradient of a truncated reconstruction at its exact rank is finite and
    0 (the loss sits at a degenerate minimum).  The stock rule raises."""
    rng = np.random.default_rng(2)
    q1, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    q2, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    a = torch.tensor(q1 @ np.diag([2.0, 2.0, 1.0, 0.0, 0.0, 0.0]) @ q2.T,
                     requires_grad=True)
    u, s, vh = T.svd_reg(a)
    rec = (u[:, :3] * s[:3]) @ vh[:3]
    (g,) = torch.autograd.grad(torch.sum((rec - a) ** 2), a)
    assert torch.isfinite(g).all()
    assert g.abs().max().item() <= 1e-8
    # a complex degenerate input, where torch's stock backward raises
    ac = torch.tensor(q1 @ np.diag([1.0, 1.0, 0.0, 0.0, 0.0, 0.0]) @ q2.T
                      + 0j, requires_grad=True)
    u, s, vh = T.svd_reg(ac)
    (g,) = torch.autograd.grad(torch.sum(u.abs()) + s.sum(), ac)
    assert torch.isfinite(g).all()


def test_eigh_reg_degenerate_zero_cluster_finite():
    """A rank-deficient Gram matrix (a cluster of exact zero eigenvalues,
    what ``gram_qr`` sees on a padded bond) gives a finite gradient."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 2)) + 1j * rng.normal(size=(6, 2))
    g_mat = torch.tensor(x @ x.conj().T, requires_grad=True)
    w, v = T.eigh_reg(g_mat)
    (g,) = torch.autograd.grad(w.sum() + v.abs().sum(), g_mat)
    assert torch.isfinite(g).all()


def test_qr_reg_rank_deficient_bounded_and_wide_raises():
    rng = np.random.default_rng(3)
    b = np.column_stack([rng.normal(size=7), rng.normal(size=7) * 1e-16,
                         rng.normal(size=7), np.zeros(7)])
    bt = torch.tensor(b, requires_grad=True)
    q, r = T.qr_reg(bt)
    (g,) = torch.autograd.grad(torch.sum((q @ r - bt) ** 2), bt)
    assert torch.isfinite(g).all()
    assert g.abs().max().item() <= 1e-8
    wide = torch.tensor(rng.normal(size=(3, 5)), requires_grad=True)
    q, r = T.qr_reg(wide)
    with pytest.raises(NotImplementedError, match="tall/square"):
        torch.autograd.grad(q.sum() + r.sum(), wide)
    with pytest.raises(NotImplementedError, match="tall/square"):
        _port_jvp(T.qr_reg, wide.detach().numpy(), np.ones((3, 5)))


def test_sqrt_reg_zero_has_zero_derivative():
    s = torch.tensor([0.0, 4.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(T.sqrt_reg(s).sum(), s)
    assert g[0].item() == 0.0
    assert abs(g[1].item() - 0.25) <= 1e-12
    _, (tangent,) = _port_jvp(T.sqrt_reg, np.array([0.0, 4.0]),
                              np.array([1.0, 1.0]))
    assert tangent[0] == 0.0 and abs(tangent[1] - 0.25) <= 1e-12
