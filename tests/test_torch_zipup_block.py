"""The zip-up site kernels' CPU forms against the reference.

On a CPU tensor each site's kernel form (``_first_onelayer_kernel``,
``_first_twolayer_kernel``, ``_pair_merge_kernel``) runs its plain version
(``first_onelayer_plain``, ``first_twolayer_plain``, ``pair_merge_plain``).
Both are held here against the reference's ``_first_onelayer_pallas``,
``_first_twolayer_pallas`` and ``_pair_merge_pallas`` in interpret mode and
against the port's dense (einsum) forms, on the same numpy inputs.  The
CUDA kernels themselves are held against the plain versions in
``tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (imports the reference's kernels in order)
from repro.kernels import dispatch as RD  # noqa: E402
from repro.kernels import zipup_block as RZ  # noqa: E402
from repro_torch.core.engines import zipup as ZE  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import zipup_block as Z  # noqa: E402

# f32 and bf16 multiplicands alike: the same f32 products (a product of two
# bf16 values is exact in f32) summed in another order.
F32_TOL = 1e-5


def t1_flip_tol(n_t1):
    """The two-layer site with bf16 multiplicands on normal inputs: a t1
    entry whose f32 sum lies within a sum-order rounding of a bf16 tie
    rounds to the other neighbour, a last-bit flip of 2^-8 of that entry
    (about 2^-15 of the entries flip).  Allowing four flips of average
    entries out of ``n_t1`` still leaves the witness that skips t1's
    rounding (about 1e-3) ten times outside.  On dyadic inputs, where t1 is
    exact in f32, the rounding point is held at F32_TOL."""
    return max(F32_TOL, 2.0 ** -8 * (4.0 / n_t1) ** 0.5)


SITES = {
    "onelayer": (RZ._first_onelayer_pallas, Z._first_onelayer_kernel,
                 Z.first_onelayer_plain, Z._first_onelayer_dense),
    "twolayer": (RZ._first_twolayer_pallas, Z._first_twolayer_kernel,
                 Z.first_twolayer_plain, Z._first_twolayer_dense),
    "pair": (RZ._pair_merge_pallas, Z._pair_merge_kernel,
             Z.pair_merge_plain, Z._pair_merge_dense),
}
# (site, D, g): the ragged shapes (p = 2; u = U = 2 in the pair merge,
# which has no g) and the main path's D = 6, g = 36
DG = ((2, 1), (3, 7), (4, 36), (8, 128), (6, 36))
SHAPES = ([("onelayer", d, g) for d, g in DG]
          + [("twolayer", d, g) for d, g in DG]
          + [("pair", d, 0) for d, _ in DG])
# real f32 operands at D = 2, 4 and 6
REAL_SHAPES = [(site, d, g) for site, d, g in SHAPES if d in (2, 4, 6)]


def _shapes(site, d, g):
    if site == "onelayer":       # S0 (b,f,g), O0 (f,c,h,k)
        return [(1, d, g), (d, 1, d, d)]
    if site == "twolayer":       # S0 (b,f,F,g), bra (p,f,c,h,k), ket (p,F,C,H,K)
        return [(1, d, d, g), (2, d, 1, d, d), (2, d, 1, d, d)]
    return [(2, 2, d, d, d), (2, 2, d, d, d)]     # bra (p,u,l,d,r), ket


def _draw(seed, shapes, kind):
    """numpy operands: c64 or f32 normals, or ``dyadic`` c64 with parts
    k / 128, |k| <= 255 (bf16 values whose products and sums over a few
    terms are exact in f32, in any order)."""
    rng = np.random.default_rng(seed)

    def one(shape):
        if kind == "dyadic":
            re, im = (rng.integers(-255, 256, shape) / 128.0 for _ in "ri")
            return (re + 1j * im).astype(np.complex64)
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "c64":
            x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
        return x
    return [one(s) for s in shapes]


def _reference(site, xs, compute):
    prev = RD.set_kernel_compute(compute)
    try:
        return np.asarray(SITES[site][0](*(jnp.asarray(x) for x in xs)))
    finally:
        RD.set_kernel_compute(prev)


def _kernel_form(site, ts, compute):
    prev = dispatch.set_kernel_compute(compute)
    try:
        return SITES[site][1](*ts)
    finally:
        dispatch.set_kernel_compute(prev)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _held(site, ts, want, compute, tol):
    """The kernel form and the plain version on ``ts``: contiguous, in the
    final order and dtype, within ``tol`` of ``want``; no launch counted."""
    before = Z.kernel_launches()
    outs = (_kernel_form(site, ts, compute), SITES[site][2](*ts, compute))
    assert Z.kernel_launches() == before
    for got in outs:
        assert got.is_contiguous() and got.shape == want.shape
        assert got.dtype == torch.from_numpy(np.zeros(1, want.dtype)).dtype
        assert _rel(got.numpy(), want) <= tol, (site, compute)
    return outs[0]


@pytest.mark.parametrize("site,d,g,kind",
                         [s + ("c64",) for s in SHAPES]
                         + [s + ("f32",) for s in REAL_SHAPES])
def test_site_matches_reference_and_dense(site, d, g, kind):
    """f32 multiplicands at the ragged shapes: the reference's Pallas form
    and the port's dense form."""
    xs = _draw(10 + d + g, _shapes(site, d, g), kind)
    if site != "onelayer":          # bra pre-conjugated, as the engine does
        xs[0] = np.conj(xs[0])
    ts = [torch.from_numpy(x) for x in xs]
    want = _reference(site, xs, None)
    got = _held(site, ts, want, None, F32_TOL)
    dense = SITES[site][3](*ts)
    assert _rel(got.numpy(), dense.numpy()) <= F32_TOL


@pytest.mark.parametrize("d,g", [(3, 7), (6, 36), (8, 128)])
def test_t1_is_rounded_where_the_reference_rounds_it(d, g):
    """The two-layer site with bf16 multiplicands on dyadic inputs, where
    every stage-1 sum is exact in f32 and the inputs are bf16 values: the
    port rounds t1 where the reference rounds it, to F32_TOL, and the
    witness that skips t1's rounding misses by more than ten times that."""
    xs = _draw(20 + d, _shapes("twolayer", d, g), "dyadic")
    ts = [torch.from_numpy(x) for x in xs]
    want = _reference("twolayer", xs, "bfloat16")
    _held("twolayer", ts, want, "bfloat16", F32_TOL)
    t1 = torch.einsum("bfFg,pfchk->bFgpchk", ts[0], ts[1])
    witness = torch.einsum("bFgpchk,pFCHK->bcChHgkK", t1, ts[2])
    assert _rel(witness.numpy(), want) > 10 * F32_TOL


@pytest.mark.parametrize("site,d,g", [("onelayer", 4, 36), ("twolayer", 4, 36),
                                      ("pair", 4, 0), ("onelayer", 6, 36),
                                      ("twolayer", 6, 36), ("pair", 6, 0)])
@pytest.mark.parametrize("kind", ["c64", "f32"])
def test_bf16_multiplicands_match_reference(site, d, g, kind):
    """bf16 multiplicands on normal inputs: the one-contraction sites to
    summation order, the two-layer site within a few flips of t1's last
    bf16 bit (``t1_flip_tol``); off the f32 result, so bf16 is engaged."""
    xs = _draw(30 + d, _shapes(site, d, g), kind)
    ts = [torch.from_numpy(x) for x in xs]
    want = _reference(site, xs, "bfloat16")
    tol = F32_TOL
    if site == "twolayer":
        b, f, F, g = xs[0].shape
        p, _, c, h, k = xs[1].shape
        tol = t1_flip_tol(b * F * g * p * c * h * k)
    _held(site, ts, want, "bfloat16", tol)
    assert 10 * F32_TOL < _rel(want, _reference(site, xs, None)) <= 2e-2


@pytest.mark.parametrize("site", ["onelayer", "twolayer", "pair"])
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_conj_and_strided_views_read_as_their_values(site, compute):
    """A conj view of the bra, a permuted S0 and a sliced ket give what
    their materialized values give in the reference."""
    d, g = 4, 36
    kind = "dyadic" if compute else "c64"
    xs = _draw(40, _shapes(site, d, g), kind)
    ts = [torch.from_numpy(x) for x in xs]
    if site == "onelayer":
        # S0 as a permuted view of a (b, g, f) tensor
        ts[0] = torch.from_numpy(np.ascontiguousarray(
            xs[0].transpose(0, 2, 1))).permute(0, 2, 1)
        assert not ts[0].is_contiguous()
    else:
        bra = 0 if site == "pair" else 1
        ts[bra] = torch.from_numpy(np.conj(xs[bra])).conj()
        assert ts[bra].is_conj()
        if site == "twolayer":
            ts[0] = torch.from_numpy(np.ascontiguousarray(
                xs[0].transpose(3, 0, 1, 2))).permute(1, 2, 3, 0)
            assert not ts[0].is_contiguous()
        # the ket, every other entry of a longer last axis
        wide = np.zeros(xs[-1].shape[:-1] + (2 * xs[-1].shape[-1],),
                        xs[-1].dtype)
        wide[..., ::2] = xs[-1]
        ts[-1] = torch.from_numpy(wide)[..., ::2]
        assert not ts[-1].is_contiguous()
    want = _reference(site, xs, compute)
    _held(site, ts, want, compute, F32_TOL)


@pytest.mark.parametrize("dtypes", [("f32", "c64"), ("c64", "f32"),
                                    ("bf16", "bf16")])
def test_mixed_and_bf16_operands_are_promoted(dtypes):
    """A real operand of a complex call is promoted to complex64; two bf16
    operands are widened to f32 and give a bf16 output, as the reference's
    result type is (then both round the same f32 sums, up to a last-bit
    flip, 2^-8)."""
    xs = _draw(50, _shapes("onelayer", 3, 7), "c64")
    xs = [x if t == "c64" else x.real.copy() for x, t in zip(xs, dtypes)]
    jxs = [jnp.asarray(x).astype(jnp.bfloat16) if t == "bf16"
           else jnp.asarray(x) for x, t in zip(xs, dtypes)]
    ts = [torch.from_numpy(x).to(torch.bfloat16) if t == "bf16"
          else torch.from_numpy(x) for x, t in zip(xs, dtypes)]
    want = np.asarray(RZ._first_onelayer_pallas(*jxs))
    got = Z._first_onelayer_kernel(*ts)
    if dtypes == ("bf16", "bf16"):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert _rel(got.float().numpy(), want.astype(np.float32)) <= 2.0 ** -8
    else:
        assert got.dtype == torch.complex64 and got.is_contiguous()
        assert _rel(got.numpy(), want) <= F32_TOL


def test_bf16_operands_round_t1_as_the_reference():
    """Two bf16 operands of the two-layer site's first stage: the
    reference's stage-1 result is bf16, so t1 is rounded without bf16
    multiplicands too."""
    xs = _draw(51, _shapes("twolayer", 3, 7), "dyadic")
    xs = [x.real.astype(np.float32) for x in xs]
    ts = [torch.from_numpy(x).to(torch.bfloat16) for x in xs[:2]]
    ts.append(torch.from_numpy(xs[2]))
    want = np.asarray(RZ._first_twolayer_pallas(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in xs[:2]),
        jnp.asarray(xs[2])))
    got = Z._first_twolayer_kernel(*ts)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= F32_TOL
    unrounded = torch.einsum("bfFg,pfchk,pFCHK->bcChHgkK",
                             *(t.float() for t in ts))
    assert _rel(unrounded.numpy(), want) > 10 * F32_TOL


@pytest.mark.parametrize("dtype", [torch.complex128, torch.float64])
@pytest.mark.parametrize("site", ["onelayer", "twolayer", "pair"])
def test_kernel_forms_refuse_double_precision(site, dtype):
    """f64 and c128 never reach a kernel: dispatch routes them dense, and a
    direct call of a kernel form raises TypeError."""
    ts = [torch.from_numpy(x).to(dtype) for x in
          _draw(60, _shapes(site, 2, 3), "c64" if dtype.is_complex
                else "f32")]
    with pytest.raises(TypeError, match="complex64"):
        SITES[site][1](*ts)


def test_kernel_forms_refuse_shapes_that_do_not_contract():
    s0, o0 = (torch.zeros(s, dtype=torch.complex64)
              for s in ((1, 3, 4), (2, 1, 3, 3)))
    with pytest.raises(ValueError, match="do not contract"):
        Z._first_onelayer_kernel(s0, o0)
    s0, tb, tk = (torch.zeros(s, dtype=torch.complex64)
                  for s in ((1, 3, 2, 4), (2, 3, 1, 2, 2), (2, 3, 1, 2, 2)))
    with pytest.raises(ValueError, match="do not contract"):
        Z._first_twolayer_kernel(s0, tb, tk)


@pytest.mark.parametrize("twolayer", [False, True])
def test_engine_reshape_after_the_site_is_a_view(twolayer):
    """In kernel mode the site's output is contiguous, so the first
    column's carry is a view of it: the site's output recorded, and the
    carry checked to share its storage."""
    from repro_torch.core.einsumsvd import DirectSVD
    seen = []
    name = "zipup_first_twolayer" if twolayer else "zipup_first_onelayer"
    site = dispatch.site(name)

    def recording(*args):
        out = site.kernel_fn(*args)
        seen.append(out)
        return out

    rng = np.random.default_rng(70)

    def c(*s):
        return torch.from_numpy((rng.standard_normal(s)
                                 + 1j * rng.standard_normal(s))
                                .astype(np.complex64))
    prev = dispatch.set_kernel_backend("kernel")
    dispatch.register_kernel(name, kernel=recording, dense=site.dense_fn,
                             supported=site.supported, auto=site.auto)
    try:   # the first column alone: the carry is the site's output reshaped
        if twolayer:
            _, carry = ZE.zipup_block_twolayer(
                None, [c(1, 3, 3, 4)], [c(2, 3, 1, 3, 3)], [c(2, 3, 1, 3, 3)],
                4, DirectSVD(), [None], first=True, last=False)
        else:
            _, carry = ZE.zipup_block(None, [c(1, 3, 4)], [c(3, 1, 3, 3)], 4,
                                      DirectSVD(), [None], first=True,
                                      last=False)
    finally:
        dispatch.register_kernel(name, kernel=site.kernel_fn,
                                 dense=site.dense_fn,
                                 supported=site.supported, auto=site.auto)
        dispatch.set_kernel_backend(prev)
    assert len(seen) == 1 and seen[0].is_contiguous()
    assert carry.data_ptr() == seen[0].data_ptr()
