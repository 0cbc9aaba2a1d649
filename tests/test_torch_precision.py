"""The port's precision policies (PEPS item 2) against the reference.

``ERROR_BUDGETS`` equals the reference's table value for value and renders
the same markdown.  The policy plumbing: ``wrap_svd`` is idempotent, the
exact policy builds the bare option (``BMPS(chi)`` is the option it always
was), ``einsumsvd(precision="mixed")`` gives the exact path's dtypes back.
Then each mixed acceptance case of the table holds against the port's own
exact run of the identical contraction within its budget, the port's mixed
run lies within 1e-5 of the reference's mixed run on the same tensors and
keys, and a forced-``kernel`` solve under the mixed policy runs its kernel
sites with bf16 multiplicands and restores the compute dtype afterwards.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import CPU, JaxKey  # noqa: E402

from repro.core import bmps as RB  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core import precision as RPREC  # noqa: E402
from repro_torch.core import bmps as TB  # noqa: E402
from repro_torch.core import ite as TI  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core import statevector as sv  # noqa: E402
from repro_torch.core.circuits import apply_circuit_exact_peps, \
    apply_circuit_statevector, random_circuit  # noqa: E402
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD, \
    einsumsvd  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402
from repro_torch.core.precision import (ERROR_BUDGETS, EXACT, MIXED,  # noqa: E402
                                        PrecisionWrapped,
                                        budget_table_markdown, demote_dtype,
                                        error_budget, policy_of, real_dtype,
                                        resolve_precision, wrap_svd)
from repro_torch.kernels import dispatch  # noqa: E402

ES = importlib.import_module("repro_torch.core.einsumsvd")
ORTH = importlib.import_module("repro_torch.core.orthogonalize")
RSVD = importlib.import_module("repro_torch.core.rsvd")
K17 = TorchKey(17)


def _rel(a, b):
    return abs(complex(a) - complex(b)) / abs(complex(b))


# ------------------------------------------------------------------ table --

def test_budget_table_equals_the_reference():
    assert ERROR_BUDGETS == RPREC.ERROR_BUDGETS
    assert list(ERROR_BUDGETS) == list(RPREC.ERROR_BUDGETS)
    assert budget_table_markdown() == RPREC.budget_table_markdown()
    for name in ERROR_BUDGETS:
        for policy in ("exact", "mixed"):
            assert error_budget(name, policy) == \
                RPREC.error_budget(name, policy)


def test_error_budget_lookup():
    assert error_budget("amplitude", "exact") == 1e-12
    assert error_budget("amplitude", MIXED) == \
        ERROR_BUDGETS["amplitude"]["mixed"]
    with pytest.raises(KeyError, match="no budget"):
        error_budget("nonsense_workload", "exact")


# ----------------------------------------------------------------- policy --

def test_resolve_precision_rejects_unknown():
    with pytest.raises(TypeError, match=r"exact.*mixed|mixed.*exact"):
        resolve_precision("fast")
    with pytest.raises(TypeError):
        resolve_precision(32)
    assert resolve_precision("exact") is EXACT
    assert resolve_precision(MIXED) is MIXED


def test_demotion_is_one_tier():
    for hi, lo in ((torch.complex128, torch.complex64),
                   (torch.float64, torch.float32),
                   (torch.complex64, torch.complex64),
                   (torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16)):
        assert demote_dtype(hi, MIXED) == lo
        assert demote_dtype(hi, EXACT) == hi
    assert real_dtype(torch.complex128) == torch.float64
    assert real_dtype(torch.complex64) == torch.float32


def test_wrap_svd_exact_is_identity():
    opt = DirectSVD()
    assert wrap_svd(opt, "exact") is opt
    assert policy_of(opt) is EXACT


def test_wrap_svd_idempotent_both_directions():
    opt = RandomizedSVD()
    mixed = wrap_svd(opt, "mixed")
    assert isinstance(mixed, PrecisionWrapped) and mixed.inner is opt
    assert policy_of(mixed) is MIXED
    assert wrap_svd(mixed, "mixed").inner is opt
    assert wrap_svd(mixed, "mixed") == mixed
    assert wrap_svd(mixed, "exact") is opt


def test_exact_options_equal_the_prepolicy_options():
    """``BMPS(chi)`` builds the option it built before the policies: the
    svd is not wrapped, so every existing path runs unchanged."""
    assert TB.BMPS(8) == TB.BMPS(8, precision="exact")
    assert TB.BMPS(8).svd == DirectSVD()
    assert TB.BMPS.randomized(8).svd == RandomizedSVD()
    assert repr(TB.BMPS(8)) == ("BMPS(chi=8, svd=DirectSVD(cutoff=0.0), "
                                "engine='zipup', precision='exact')")
    mixed = TB.BMPS(8, precision="mixed")
    assert isinstance(mixed.svd, PrecisionWrapped)
    assert mixed.svd.inner == DirectSVD()
    with pytest.raises(TypeError, match="precision"):
        TB.BMPS(8, precision="double")


def test_env_option_keeps_the_env_svd_policy():
    from repro_torch.core.full_update import env_option
    upd = TP.FullUpdate(rank=2, chi=6, env_svd=wrap_svd(DirectSVD(), "mixed"))
    assert policy_of(env_option(upd).svd) is MIXED
    assert env_option(TP.FullUpdate(rank=2, chi=6)) == TB.BMPS(6)


def test_einsumsvd_precision_kwarg_roundtrips_dtype():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((6, 5, 7)))
    b = torch.from_numpy(rng.standard_normal((7, 4, 3)))
    args = ([a, b], ["abc", "cde"])
    ue, se, ve = einsumsvd(DirectSVD(), *args, row="ab", col="de", rank=4,
                           absorb="none", key=K17)
    um, sm, vm = einsumsvd(DirectSVD(), *args, row="ab", col="de", rank=4,
                           absorb="none", key=K17, precision="mixed")
    assert (um.dtype, sm.dtype, vm.dtype) == (ue.dtype, se.dtype, ve.dtype)
    np.testing.assert_allclose(sm.numpy(), se.numpy(), rtol=1e-5)
    c = (a + 1j * a).to(torch.complex128)
    um, sm, vm = einsumsvd(DirectSVD(), [c, b.to(c.dtype)], ["abc", "cde"],
                           row="ab", col="de", rank=4, absorb="none",
                           precision="mixed")
    assert (um.dtype, sm.dtype, vm.dtype) == (torch.complex128,
                                              torch.float64,
                                              torch.complex128)


def test_mixed_scaling_handles_unnormalized_operands():
    """The per-solve scaling keeps a badly scaled network solvable: mixed
    on 1e-5 operands matches the exact solve of the scaled operands."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(1e-5 * rng.standard_normal((40, 6, 9)))
    b = torch.from_numpy(1e-5 * rng.standard_normal((9, 6, 30)))
    _, s_ref, _ = einsumsvd(RandomizedSVD(), [a * 1e5, b * 1e5],
                            ["abc", "cde"], row="ab", col="de", rank=4,
                            absorb="none", key=K17)
    _, sm, _ = einsumsvd(RandomizedSVD(), [a, b], ["abc", "cde"], row="ab",
                         col="de", rank=4, absorb="none", key=K17,
                         precision="mixed")
    np.testing.assert_allclose(sm.numpy(), s_ref.numpy() * 1e-10, rtol=1e-4)


def test_forced_kernel_mixed_solve_multiplies_in_bf16(monkeypatch):
    """Under the mixed policy a forced-kernel solve reaches its kernels
    with bf16 multiplicands (the card's bf16 instantiations), and the
    compute dtype is restored afterwards."""
    seen = {}

    def recording(name, fn):
        def kernel(*args, compute=None, **kwargs):
            seen.setdefault(name, set()).add(compute)
            return fn(*args, compute=compute, **kwargs)
        return kernel

    monkeypatch.setattr(ORTH, "gram_complex",
                        recording("gram", ORTH.gram_complex))
    monkeypatch.setattr(ORTH, "planar_matmul",
                        recording("tall_apply", ORTH.planar_matmul))
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.standard_normal((64, 3, 4))
                         + 1j * rng.standard_normal((64, 3, 4)))
    prev = dispatch.set_kernel_backend("kernel")
    try:
        u, s_mixed, v = einsumsvd(RandomizedSVD(), [t], ["abc"], row="a",
                                  col="bc", rank=4, absorb="none", key=K17,
                                  precision="mixed")
        assert dispatch.kernel_compute() is None
        # the Gram and the rSVD's final projections in bf16; the Gram-QR's
        # Q = A R^{-1} in the operand's multiplicands (R^{-1} is
        # ill-conditioned)
        assert seen == {"gram": {"bfloat16"}, "tall_apply": {"bfloat16", None}}
        assert u.dtype == torch.complex128
        seen.clear()
        _, s_exact, _ = einsumsvd(RandomizedSVD(), [t.to(torch.complex64)],
                                  ["abc"], row="a", col="bc", rank=4,
                                  absorb="none", key=K17)
        assert seen == {"gram": {None}, "tall_apply": {None}}
    finally:
        dispatch.set_kernel_backend(prev)
    rel = float(torch.linalg.norm(s_mixed - s_exact.double())
                / torch.linalg.norm(s_exact.double()))
    assert rel <= error_budget("kernel_bf16_gemm", "mixed")


@pytest.mark.parametrize("option", [DirectSVD(), RandomizedSVD()],
                         ids=["direct", "randomized"])
def test_only_mixed_solves_ask_for_the_wide_svd(monkeypatch, option):
    """The mixed policy's solves ask ``svd_reg`` for the double-precision
    SVD of a single-precision matrix on the card; the exact path never
    does, so its SVD stays torch's own."""
    seen = []
    for mod in (ES, RSVD):
        def svd_reg(mat, wide=False, inner=mod.svd_reg):
            seen.append(wide)
            return inner(mat, wide)
        monkeypatch.setattr(mod, "svd_reg", svd_reg)
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.standard_normal((16, 3, 4))
                         + 1j * rng.standard_normal((16, 3, 4)))
    for precision, want in (("mixed", True), (None, False)):
        seen.clear()
        einsumsvd(option, [t], ["abc"], row="a", col="bc", rank=4,
                  absorb="none", key=K17, precision=precision)
        assert seen and set(seen) == {want}


# ------------------------------------------------- the mixed budget cases --
#
# Each case holds the port's mixed run against the port's exact run of the
# identical contraction (same chi, engine, key), and the port's mixed run
# against the reference's on the same tensors and keys.

@pytest.fixture(scope="module")
def onelayer_rows():
    return TP.random_onelayer(4, 4, 3, torch.Generator().manual_seed(42),
                              device=CPU)


@pytest.mark.parametrize("randomized", [False, True])
def test_mixed_budget_contract_onelayer(onelayer_rows, randomized):
    tol = error_budget("contract_onelayer", "mixed")
    make = TB.BMPS.randomized if randomized else TB.BMPS
    e = TB.contract_onelayer(onelayer_rows, make(8), key=K17)
    m = TB.contract_onelayer(onelayer_rows, make(8, precision="mixed"),
                             key=K17)
    assert _rel(m, e) <= tol, f"{_rel(m, e):.3e} > {tol:.0e}"


def test_mixed_contract_onelayer_matches_the_reference(onelayer_rows):
    ref = RB.contract_onelayer(
        [[jax.numpy.asarray(t.numpy()) for t in row] for row in onelayer_rows],
        RB.BMPS(8, precision="mixed"), key=jax.random.PRNGKey(17))
    port = TB.contract_onelayer(onelayer_rows, TB.BMPS(8, precision="mixed"),
                                key=JaxKey(17))
    assert _rel(port, ref) <= 1e-5


@pytest.fixture(scope="module")
def tfi44():
    obs = tfi_hamiltonian(4, 4, jz=-1.0, hx=-3.5)
    run = TI.ite_run(TP.computational_zeros(4, 4, device=CPU), obs, 0.05, 10,
                     TP.QRUpdate(rank=3), TB.BMPS(16), measure_every=10)
    return obs, run.state


def test_mixed_budget_contract_twolayer(tfi44):
    tol = error_budget("contract_twolayer", "mixed")
    _, state = tfi44
    e = TB.norm_squared(state, TB.BMPS(8), K17)
    m = TB.norm_squared(state, TB.BMPS(8, precision="mixed"), K17)
    assert _rel(m, e) <= tol, f"{_rel(m, e):.3e} > {tol:.0e}"


def test_mixed_budget_amplitude_rqc():
    circ = random_circuit(3, 3, 8, seed=3)
    state = apply_circuit_exact_peps(TP.computational_zeros(3, 3, device=CPU),
                                     circ)
    bits = np.zeros((3, 3), dtype=int)
    e = TB.amplitude(state, bits, TB.BMPS(8), K17)
    m = TB.amplitude(state, bits, TB.BMPS(8, precision="mixed"), K17)
    vec = apply_circuit_statevector(sv.zeros(9, device=CPU), circ)
    assert _rel(e, vec[(0,) * 9]) <= error_budget("amplitude", "exact")
    tol = error_budget("amplitude", "mixed")
    assert _rel(m, e) <= tol, f"{_rel(m, e):.3e} > {tol:.0e}"
    # the reference's mixed amplitude of the same state
    ref_state = RP.PEPS([[jax.numpy.asarray(t.numpy()) for t in row]
                         for row in state.sites], float(state.log_scale))
    ref = RB.amplitude(ref_state, bits, RB.BMPS(8, precision="mixed"),
                       jax.random.PRNGKey(17))
    assert _rel(m, ref) <= 1e-5


def _fu_energy(obs, precision, key=None):
    upd = TP.FullUpdate(rank=3, chi=8, svd=wrap_svd(DirectSVD(), precision),
                        env_svd=wrap_svd(DirectSVD(), precision))
    res = TI.ite_run(TP.computational_zeros(4, 4, device=CPU), obs, 0.05, 1,
                     upd, TB.BMPS(8, precision=precision), measure_every=1,
                     key=key)
    return res.energies[-1]


def test_mixed_budget_full_update_ite_step(tfi44):
    tol = error_budget("full_update_ite_step", "mixed")
    obs, _ = tfi44
    ee, em = _fu_energy(obs, "exact"), _fu_energy(obs, "mixed")
    err = abs(em - ee) / abs(ee)
    assert err <= tol, f"{err:.3e} > {tol:.0e}"


def test_forced_kernel_mixed_contractions_hold_the_bf16_budget(onelayer_rows,
                                                              tfi44):
    """With bf16 multiplicands in the Gram and the final projections
    (forced kernel mode, randomized SVD), whole contractions stay within
    the table's bf16 budget of their exact runs: the Gram's eigenvalues
    are clamped at bf16's resolution and Q = A R^{-1} keeps the operand's
    multiplicands.  Without the clamp the norm lands 2.4e4 off, with Q in
    bf16 both cases miss 2e-2 (``tools/precision_drivers.py
    --ablations``)."""
    tol = error_budget("kernel_bf16_gemm", "mixed")
    _, state = tfi44
    prev = dispatch.set_kernel_backend("kernel")
    try:
        for run in (lambda p: TB.contract_onelayer(
                        onelayer_rows, TB.BMPS.randomized(8, precision=p),
                        key=K17),
                    lambda p: TB.norm_squared(
                        state, TB.BMPS.randomized(8, precision=p), K17)):
            e, m = run("exact"), run("mixed")
            assert _rel(m, e) <= tol, f"{_rel(m, e):.3e} > {tol:.0e}"
    finally:
        dispatch.set_kernel_backend(prev)
