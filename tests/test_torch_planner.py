"""The port's own contraction-path search against opt_einsum.

The card's machine has no opt_einsum, so ``repro_torch.core.planner``
searches its own paths (exact dynamic program over operand subsets).  Here,
where opt_einsum is importable, every einsumsvd/strip network of the slice
must cost no more flops than opt_einsum's path with the reference's own
optimizer choice ("optimal" up to 6 operands, "dp" above), both costed by
opt_einsum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
opt_einsum = pytest.importorskip("opt_einsum")

from repro_torch.core import planner  # noqa: E402
from repro_torch.core.bmps import BMPS, amplitude  # noqa: E402
from repro_torch.core.einsumsvd import DirectSVD  # noqa: E402
from repro_torch.core.expectation import expectation  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402
from repro_torch.core.peps import DirectUpdate, QRUpdate, apply_operator, \
    random_peps  # noqa: E402
from repro_torch.core.gates import gate  # noqa: E402


def _opt_cost(expr, shapes, path):
    _, info = opt_einsum.contract_path(expr, *shapes, shapes=True,
                                       optimize=path)
    return int(info.opt_cost)


def _ref_cost(expr, shapes):
    _, info = opt_einsum.contract_path(
        expr, *shapes, shapes=True,
        optimize="optimal" if len(shapes) <= 6 else "dp")
    return int(info.opt_cost)


def _sizes(expr, shapes):
    lhs, _ = expr.split("->")
    sizes = {}
    for sub, shape in zip(lhs.split(","), shapes):
        sizes.update(zip(sub, shape))
    return sizes


def _assert_no_worse(expr, shapes):
    lhs, out = expr.split("->")
    path = planner.search_path(lhs.split(","), out, _sizes(expr, shapes))
    ours = _opt_cost(expr, shapes, path)
    theirs = _ref_cost(expr, shapes)
    assert ours <= theirs, (expr, shapes, ours, theirs)


@pytest.fixture(scope="module")
def slice_networks():
    """Every (expr, shapes) the slice's main path looks up, recorded from a
    small run: QR/direct gate updates, one- and two-layer zip-up einsumsvd
    networks (dense and matvec forms), and the 1- and 2-row strips."""
    planner.clear()
    gen = torch.Generator().manual_seed(0)
    state = random_peps(3, 3, 2, gen, device="cpu")
    state = apply_operator(state, gate("CX"), [0, 1], QRUpdate(rank=3))
    state = apply_operator(state, gate("CX"), [4, 7], DirectUpdate(rank=3))
    for opt in (BMPS(4), BMPS.randomized(4, niter=1)):
        expectation(state, tfi_hamiltonian(3, 3), opt)
        amplitude(state, np.zeros(9, dtype=int), opt)
    return list(planner._PATH_CACHE)


def test_recorded_networks_cover_the_slice(slice_networks):
    n_ops = {len(expr.split("->")[0].split(",")) for expr, _ in slice_networks}
    assert {3, 4, 5, 7} <= n_ops   # gate/zip-up nets, sketches, 2-row strips


def test_path_costs_no_more_than_opt_einsum_on_slice_networks(slice_networks):
    for expr, shapes in slice_networks:
        _assert_no_worse(expr, shapes)


@pytest.mark.parametrize("case", ["onelayer", "twolayer", "qr", "direct"])
def test_path_costs_no_more_than_opt_einsum_at_main_path_sizes(case):
    """The einsumsvd networks at the 8x8, D=6, chi=64 smoke sizes."""
    D, chi, k = 6, 64, 72
    nets = {
        "onelayer": (["aebc", "bfg", "fchk"], [(chi, D, chi, D), (chi, D, chi),
                                              (D, D, D, D)], "ae", "hgk"),
        "twolayer": (["aeEbcC", "bfFg", "pfchk", "pFCHK"],
                     [(chi, D, D, chi, D, D), (chi, D, D, chi),
                      (2, D, D, D, D), (2, D, D, D, D)], "aeE", "hHgkK"),
        "qr": (["xypq", "abpk", "cdqk"], [(2, 2, 2, 2), (2, D, 2, D),
                                          (2, D, 2, D)], "xab", "ycd"),
        "direct": (["xypq", "puldk", "qUkDR"], [(2, 2, 2, 2), (2, D, D, D, D),
                                                (2, D, D, D, D)], "xuld", "yUDR"),
    }
    subs, shapes, row, col = nets[case]
    sizes = {}
    for s, sh in zip(subs, shapes):
        sizes.update(zip(s, sh))
    z = "Z"
    row_k = tuple(sizes[c] for c in row) + (k,)
    col_k = tuple(sizes[c] for c in col) + (k,)
    _assert_no_worse(",".join(subs) + "->" + row + col, shapes)
    _assert_no_worse(",".join(subs + [col + z]) + "->" + row + z,
                     shapes + [col_k])
    _assert_no_worse(",".join(subs + [row + z]) + "->" + col + z,
                     shapes + [row_k])


def test_cached_einsum_matches_einsum_and_counts():
    rng = np.random.default_rng(1)
    a, b, c = (torch.tensor(rng.standard_normal(s)) for s in
               [(3, 4, 5), (5, 6), (6, 4, 2)])
    planner.clear()
    got = planner.cached_einsum("abc,cd,dbe->ae", a, b, c)
    want = torch.einsum("abc,cd,dbe->ae", a, b, c)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    planner.cached_einsum("abc,cd,dbe->ae", a, b, c)
    st = planner.stats()
    assert st["path_misses"] == 1 and st["path_hits"] == 1
    assert st["path_cache_size"] == 1
    with planner.disabled():
        planner.cached_einsum("abc,cd,dbe->ae", a, b, c)
    assert planner.stats()["path_uncached"] == 1


def test_int_einsum_shares_cache_across_label_counters():
    rng = np.random.default_rng(2)
    x, y = torch.tensor(rng.standard_normal((3, 4))), \
        torch.tensor(rng.standard_normal((4, 5)))
    planner.clear()
    r1 = planner.int_einsum(x, [10, 11], y, [11, 12], [10, 12])
    r2 = planner.int_einsum(x, [7, 3], y, [3, 99], [7, 99])
    torch.testing.assert_close(r1, x @ y)
    torch.testing.assert_close(r2, x @ y)
    assert planner.stats()["path_cache_size"] == 1


def test_fused_cache_replays_per_signature():
    gen = torch.Generator().manual_seed(3)
    state = random_peps(3, 3, 2, gen, device="cpu")
    from repro_torch.core.bmps import norm_squared
    opt = BMPS.randomized(4, niter=1)
    planner.clear()
    v1 = norm_squared(state, opt)
    before = planner.stats()
    assert before["fused_misses"] > 0
    v2 = norm_squared(state, opt)
    delta = planner.stats_since(before)
    assert delta["fused_misses"] == 0 and delta["fused_hits"] > 0
    assert complex(v1) == complex(v2)
    # DirectSVD never touches the fused cache
    before = planner.stats()
    norm_squared(state, BMPS(4, svd=DirectSVD()))
    assert planner.stats_since(before)["fused_misses"] == 0
