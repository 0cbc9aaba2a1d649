"""Module-level parity of the port's core against the JAX reference.

Gauge-invariant checks only (torch and LAPACK under JAX choose different
phases): Q.R and Q^H Q for ``gram_qr``, u.diag(s).v for ``randomized_svd``
(JAX-backed keys, so both draw the same sketch), left.right for
``einsumsvd``; plus the numpy leaf modules, keys and device defaults.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_helpers import JaxKey, rel_err, to_numpy, to_torch  # noqa: E402

from repro.core import gates as RGATES  # noqa: E402
from repro.core import observable as ROBS  # noqa: E402
from repro.core.einsumsvd import DirectSVD as RDirect, \
    RandomizedSVD as RRand, einsumsvd as r_einsumsvd  # noqa: E402
from repro.core.orthogonalize import gram_qr as r_gram_qr  # noqa: E402
from repro.core.rsvd import ImplicitOperator as RImplicit, \
    randomized_svd as r_randomized_svd  # noqa: E402
from repro_torch.core import gates as TGATES  # noqa: E402
from repro_torch.core import observable as TOBS  # noqa: E402
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD, \
    einsumsvd  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.orthogonalize import gram_qr, reshape_qr  # noqa: E402
from repro_torch.core.rsvd import ImplicitOperator, randomized_svd  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _crandn(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("shape,n_small", [((6, 5, 2, 3), 2), ((40, 7), 1),
                                           ((3, 2, 9), 1)])
def test_gram_qr_matches_reference(shape, n_small):
    a = _crandn(0, *shape)
    q, r = gram_qr(to_torch(a), n_small)
    rq, rr = r_gram_qr(jnp.asarray(a), n_small)
    nsmall = int(np.prod(shape[len(shape) - n_small:]))
    qm, rm = to_numpy(q).reshape(-1, nsmall), to_numpy(r).reshape(nsmall, nsmall)
    rqm, rrm = np.asarray(rq).reshape(-1, nsmall), np.asarray(rr).reshape(nsmall, nsmall)
    assert rel_err(qm @ rm, rqm @ rrm) <= 1e-12
    assert rel_err(qm @ rm, a.reshape(-1, nsmall)) <= 1e-12
    if qm.shape[0] >= nsmall:           # full column rank: Q is an isometry
        np.testing.assert_allclose(qm.conj().T @ qm, np.eye(nsmall), atol=1e-10)
    q2, r2 = reshape_qr(to_torch(a), n_small)
    assert rel_err(to_numpy(q2).reshape(-1, nsmall) @ to_numpy(r2).reshape(
        nsmall, nsmall), a.reshape(-1, nsmall)) <= 1e-12


def _network(seed):
    """A 3-tensor network with a low-rank-ish spectrum (row 'ae', col 'hgk')."""
    return [_crandn(seed, 4, 3, 5, 2), _crandn(seed + 1, 5, 3, 4),
            _crandn(seed + 2, 3, 2, 3, 2)], ["aebc", "bfg", "fchk"], "ae", "hgk"


@pytest.mark.parametrize("gram_final", [True, False])
def test_randomized_svd_matches_reference(gram_final):
    tensors, subs, row, col = _network(3)
    op = ImplicitOperator([to_torch(t) for t in tensors], subs, row, col)
    rop = RImplicit([jnp.asarray(t) for t in tensors], subs, row, col)
    u, s, v = randomized_svd(op, 5, n_iter=2, oversample=3, key=JaxKey(9),
                             gram_final=gram_final)
    ru, rs, rv = r_randomized_svd(rop, 5, n_iter=2, oversample=3,
                                  key=jax.random.PRNGKey(9),
                                  gram_final=gram_final)
    rec = np.einsum("aer,r,rhgk->aehgk", to_numpy(u), to_numpy(s), to_numpy(v))
    rrec = np.einsum("aer,r,rhgk->aehgk", ru, rs, rv)
    assert rel_err(rec, rrec) <= 1e-10
    np.testing.assert_allclose(to_numpy(s), np.asarray(rs), rtol=1e-10)


@pytest.mark.parametrize("which", ["direct", "randomized"])
@pytest.mark.parametrize("absorb", ["both", "left", "right"])
def test_einsumsvd_left_right_matches_reference(which, absorb):
    tensors, subs, row, col = _network(5)
    if which == "direct":
        opt, ropt = DirectSVD(), RDirect()
    else:
        opt, ropt = RandomizedSVD(niter=2, oversample=4), \
            RRand(niter=2, oversample=4, fused=False)
    left, right = einsumsvd(opt, [to_torch(t) for t in tensors], subs, row,
                            col, rank=4, absorb=absorb, key=JaxKey(2))
    rl, rr = r_einsumsvd(ropt, [jnp.asarray(t) for t in tensors], subs, row,
                         col, rank=4, absorb=absorb, key=jax.random.PRNGKey(2))
    got = np.einsum("aer,rhgk->aehgk", to_numpy(left), to_numpy(right))
    want = np.einsum("aer,rhgk->aehgk", rl, rr)
    assert rel_err(got, want) <= 1e-10


def test_cutoff_zeroes_trailing_singular_values():
    tensors, subs, row, col = _network(7)
    u, s, v = einsumsvd(DirectSVD(cutoff=0.5), [to_torch(t) for t in tensors],
                        subs, row, col, rank=6, absorb="none")
    s = to_numpy(s)
    assert s.shape == (6,) and s[-1] == 0.0 and s[0] > 0
    assert np.all((s == 0) | (s >= 0.5 * s[0]))


def test_gates_and_observables_equal_reference():
    for name in ("H", "X", "CX", "SWAP", "ISWAP", "SQRT_W"):
        np.testing.assert_array_equal(TGATES.gate(name), RGATES.gate(name))
    np.testing.assert_array_equal(TGATES.gate("RY", 0.3), RGATES.gate("RY", 0.3))
    np.testing.assert_array_equal(TGATES.gate("FSIM", 0.2, 0.1),
                                  RGATES.gate("FSIM", 0.2, 0.1))
    for t_obs, r_obs in [(TOBS.tfi_hamiltonian(3, 4), ROBS.tfi_hamiltonian(3, 4)),
                         (TOBS.j1j2_hamiltonian(2, 3), ROBS.j1j2_hamiltonian(2, 3))]:
        assert len(t_obs) == len(r_obs)
        for a, b in zip(t_obs, r_obs):
            assert a.sites == b.sites and a.coeff == b.coeff
            np.testing.assert_array_equal(a.gate_tensor(), b.gate_tensor())


def test_torch_key_is_deterministic_and_precision_independent():
    key = TorchKey(7)
    a, b = key.split(2)
    assert a.seed != b.seed and a.seed == TorchKey(7).split(2)[0].seed
    s64 = a.sketch((5, 3), torch.complex64, "cpu")
    s128 = a.sketch((5, 3), torch.complex128, "cpu")
    assert s64.dtype == torch.complex64 and s128.dtype == torch.complex128
    np.testing.assert_array_equal(s64.numpy().astype(np.complex128), s128.numpy())
    assert float(s64.real.abs().max()) <= 1.0
    assert not torch.equal(s64, b.sketch((5, 3), torch.complex64, "cpu"))


def test_constructors_default_to_the_card():
    """``device=None`` means CUDA: without a card it raises; the CPU runs
    only when asked for."""
    from repro_torch.convert import peps_from_numpy
    from repro_torch.core.peps import computational_basis, \
        computational_zeros, random_peps
    calls = [lambda: computational_zeros(2, 2),
             lambda: computational_basis(np.zeros((2, 2), dtype=int)),
             lambda: random_peps(2, 2, 2, torch.Generator(
                 device="cuda" if torch.cuda.is_available() else "cpu")),
             lambda: peps_from_numpy([[np.ones((2, 1, 1, 1, 1))]])]
    for make in calls:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    assert computational_zeros(2, 2, device="cpu").device.type == "cpu"


_FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in _FORBIDDEN]
    assert not bad, bad
