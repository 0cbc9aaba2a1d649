"""The port's fault injection and runtime guard (PEPS item 7).

The fault registry and the escalation ladder are held against the port's
own clean runs, as ``tests/test_runtime_guard.py`` holds the reference's:
every rung, the full-update fidelity floor and the gradient-mode guard.
Then parity with the reference on JAX-backed keys: a guarded ``ite_run``
with the same armed fault gives the same ``(site, cause, attempt,
action)`` events and energies within 1e-8.  Last, the repair of the
complex64 full update: under a guard, a ``torch.linalg.LinAlgError`` of a
bond's positive fix counts as ``"nan"`` at ``"full_update"``, the cause the
reference records where its eigh returns NaN.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import CPU, JaxKey  # noqa: E402

from repro.core import faults as RF  # noqa: E402
from repro.core import ite as RI  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core.bmps import BMPS as RBMPS  # noqa: E402
from repro.core.einsumsvd import RandomizedSVD as RRand  # noqa: E402
from repro.core.observable import tfi_hamiltonian as r_tfi  # noqa: E402
from repro_torch.core import faults, planner, runtime_guard  # noqa: E402
from repro_torch.core import full_update as TFU  # noqa: E402
from repro_torch.core import ite as TI  # noqa: E402
from repro_torch.core import peps as TP  # noqa: E402
from repro_torch.core.bmps import BMPS  # noqa: E402
from repro_torch.core.einsumsvd import DirectSVD, RandomizedSVD, \
    einsumsvd  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402
from repro_torch.core.precision import error_budget, wrap_svd  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    RF.clear()
    yield
    faults.clear()
    RF.clear()
    dispatch.set_kernel_backend("auto")


def _solve(option, rank=8, dtype=torch.float32):
    t = torch.from_numpy(np.random.default_rng(7).standard_normal((64, 32)))
    return einsumsvd(option, [t.to(dtype)], ["ab"], "a", "b", rank,
                     absorb="none", key=TorchKey(7))


def _actions(report):
    return [e.action for e in report.events]


# ---------------------------------------------------------------------------
# The fault registry
# ---------------------------------------------------------------------------

class TestFaultRegistry:
    def test_fires_on_exactly_the_nth_call(self):
        faults.arm("x", nth=3)
        assert faults.should_fire("x") is None
        assert faults.should_fire("x") is None
        spec = faults.should_fire("x")
        assert spec is not None and spec.fired == 1
        assert faults.should_fire("x") is None    # one-shot by default

    def test_times_fires_a_contiguous_window(self):
        faults.arm("x", nth=2, times=2)
        hits = [faults.should_fire("x") is not None for _ in range(5)]
        assert hits == [False, True, True, False, False]

    def test_rearm_resets_the_call_counter(self):
        faults.arm("x", nth=1)
        assert faults.should_fire("x") is not None
        faults.arm("x", nth=1)
        assert faults.should_fire("x") is not None

    def test_unarmed_site_is_a_noop(self):
        assert faults.should_fire("never-armed") is None

    def test_armed_context_disarms_on_exit(self):
        with faults.armed("x"):
            assert "x" in faults.active()
        assert "x" not in faults.active()

    def test_bad_spec_rejected(self):
        with pytest.raises(ValueError):
            faults.arm("x", nth=0)
        with pytest.raises(ValueError):
            faults.arm("x", times=0)

    def test_registry_is_the_ports_own(self):
        """Arming the reference's registry does not arm the port's."""
        RF.arm("x")
        assert faults.should_fire("x") is None


# ---------------------------------------------------------------------------
# Detection and the escalation ladder
# ---------------------------------------------------------------------------

class TestGuardLadder:
    def test_unguarded_corruption_propagates(self):
        with faults.armed("einsumsvd.result", action="nan"):
            _, s, _ = _solve(DirectSVD())
        assert torch.isnan(s).any()

    def test_nan_recovers_on_the_exact_svd_rung(self):
        before = planner.stats()
        with faults.armed("einsumsvd.result", action="nan"):
            with runtime_guard.RuntimeGuard() as g:
                _, s, _ = _solve(RandomizedSVD())
        assert torch.isfinite(s).all()
        assert _actions(g.report) == ["detected", "retry:exact_svd",
                                      "recovered:exact_svd"]
        assert g.report.ok
        delta = planner.stats_since(before)
        assert delta["guard_nan_events"] == 1
        assert delta["guard_rung_exact_svd"] == 1
        assert delta["guard_recovered"] == 1

    def test_recovery_is_within_the_exact_budget(self):
        _, s_clean, _ = _solve(DirectSVD())
        with faults.armed("einsumsvd.result", action="nan"):
            with runtime_guard.RuntimeGuard():
                _, s_rec, _ = _solve(RandomizedSVD())
        rel = float(torch.linalg.norm(s_rec - s_clean)
                    / torch.linalg.norm(s_clean))
        assert rel <= error_budget("contract_onelayer", "exact")

    def test_collapse_detected_and_recovered(self):
        with faults.armed("einsumsvd.result", action="zero"):
            with runtime_guard.RuntimeGuard() as g:
                _, s, _ = _solve(RandomizedSVD())
        assert float(s.abs().max()) > 0
        assert g.report.causes() == {"collapse": 1}

    def test_norm_floor_counts_a_small_spectrum_as_collapse(self):
        cfg = runtime_guard.GuardConfig(norm_floor=1e6, max_retries=1)
        with runtime_guard.RuntimeGuard(cfg) as g:
            with pytest.raises(runtime_guard.GuardExhaustedError) as ei:
                _solve(DirectSVD())
        assert ei.value.cause == "collapse"
        assert g.report.causes() == {"collapse": 1}

    def test_mixed_precision_escalates_to_exact_precision(self):
        opt = wrap_svd(RandomizedSVD(), "mixed")
        with faults.armed("einsumsvd.result", action="nan", times=2):
            with runtime_guard.RuntimeGuard() as g:
                _, s, _ = _solve(opt, dtype=torch.float64)
        assert torch.isfinite(s).all() and s.dtype == torch.float64
        actions = _actions(g.report)
        assert "retry:exact_precision" in actions
        assert actions[-1] == "recovered:exact_precision"
        assert g.report.counters["guard_rung_exact_precision"] == 1

    def test_kernel_fault_takes_the_dense_rung_first(self):
        """A raising kernel site retries dense first (keeping the solver);
        the forced kernel mode is back afterwards, and the next solve runs
        the kernel form again."""
        dispatch.set_kernel_backend("kernel", site="gram")
        with faults.armed("kernel.gram", times=99):
            with runtime_guard.RuntimeGuard() as g:
                _, s, _ = _solve(RandomizedSVD())
        assert torch.isfinite(s).all()
        assert _actions(g.report) == ["detected", "retry:dense_kernel",
                                      "recovered:dense_kernel"]
        assert g.report.causes() == {"exception": 1}
        assert g.report.counters["guard_rung_dense_kernel"] == 1
        assert dispatch.kernel_backend("gram") == "kernel"
        before = dispatch.dispatch_stats()["kernel_gram_calls"]
        _solve(RandomizedSVD())
        assert dispatch.dispatch_stats()["kernel_gram_calls"] > before

    def test_kernel_fault_unguarded_raises_injected_fault(self):
        dispatch.set_kernel_backend("kernel", site="gram")
        before = dispatch.dispatch_stats()["kernel_gram_calls"]
        with faults.armed("kernel.gram"):
            with pytest.raises(faults.InjectedFault) as ei:
                _solve(RandomizedSVD())
        assert ei.value.site == "kernel.gram"
        # it fires before the kernel runs and before the counter ticks
        assert dispatch.dispatch_stats()["kernel_gram_calls"] == before

    def test_kernel_site_fires_only_on_the_kernel_route(self):
        dispatch.set_kernel_backend("dense")
        with faults.armed("kernel.gram", times=99):
            _, s, _ = _solve(RandomizedSVD())
        assert torch.isfinite(s).all()

    def test_exhausted_ladder_raises_structured_never_nan(self):
        with faults.armed("einsumsvd.result", action="nan", times=99):
            with runtime_guard.RuntimeGuard() as g:
                with pytest.raises(runtime_guard.GuardExhaustedError) as ei:
                    _solve(RandomizedSVD())
        err = ei.value
        assert err.site == "einsumsvd" and err.cause == "nan"
        assert err.attempts == 2 and err.events
        assert not g.report.ok
        assert g.report.counters["guard_exhausted"] == 1

    def test_max_retries_bounds_the_ladder(self):
        cfg = runtime_guard.GuardConfig(max_retries=1)
        with faults.armed("einsumsvd.result", action="nan", times=99):
            with runtime_guard.RuntimeGuard(cfg):
                with pytest.raises(runtime_guard.GuardExhaustedError) as ei:
                    _solve(RandomizedSVD())
        assert ei.value.attempts == 1

    def test_resolve_accepts_the_documented_forms(self):
        assert runtime_guard.resolve(None) is None
        assert runtime_guard.resolve(False) is None
        assert isinstance(runtime_guard.resolve(True),
                          runtime_guard.RuntimeGuard)
        cfg = runtime_guard.GuardConfig(max_retries=7)
        assert runtime_guard.resolve(cfg).config.max_retries == 7
        g = runtime_guard.RuntimeGuard()
        assert runtime_guard.resolve(g) is g
        with pytest.raises(TypeError):
            runtime_guard.resolve("yes")

    def test_counters_surface_in_planner_stats_and_reset(self):
        with faults.armed("einsumsvd.result", action="nan"):
            with runtime_guard.RuntimeGuard():
                _solve(RandomizedSVD())
        s = planner.stats()
        for k in ("guard_nan_events", "guard_recovered", "guard_exhausted",
                  "guard_rung_dense_kernel"):
            assert k in s
        assert s["guard_recovered"] >= 1
        planner.reset_stats()
        assert all(v == 0 for k, v in planner.stats().items()
                   if k.startswith("guard_"))

    def test_suspended_hides_the_stack(self):
        with runtime_guard.RuntimeGuard() as g:
            with runtime_guard.suspended():
                assert runtime_guard.current() is None
            assert runtime_guard.current() is g
        assert runtime_guard.current() is None


# ---------------------------------------------------------------------------
# Full-update fidelity floor
# ---------------------------------------------------------------------------

def _tiny_full_ite(guard, steps=1):
    return TI.ite_run(TP.computational_zeros(2, 2, device=CPU),
                      tfi_hamiltonian(2, 2), 0.05, steps,
                      TP.FullUpdate(rank=2, chi=8), BMPS(8), measure_every=1,
                      guard=guard)


class TestFidelityFloor:
    def test_degraded_accepted_warns_and_continues(self):
        cfg = runtime_guard.GuardConfig(fidelity_floor=1.5)  # unreachable
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = _tiny_full_ite(cfg)
        assert any("fidelity" in str(x.message) for x in w)
        assert res.guard.counters.get("guard_fidelity_events", 0) >= 1
        assert res.guard.counters.get("guard_degraded_accepted", 0) >= 1
        assert all(np.isfinite(e) for e in res.energies)
        assert res.guard.ok

    def test_strict_floor_raises_structured(self):
        cfg = runtime_guard.GuardConfig(fidelity_floor=1.5,
                                        fidelity_strict=True)
        with pytest.raises(runtime_guard.GuardExhaustedError) as ei:
            _tiny_full_ite(cfg)
        assert ei.value.site == "full_update"
        assert ei.value.cause == "fidelity"

    def test_clean_run_has_an_empty_report_and_unguarded_energies(self):
        res = _tiny_full_ite(True, steps=2)
        assert res.guard is not None and res.guard.ok
        assert res.guard.events == []
        plain = _tiny_full_ite(None, steps=2)
        assert plain.guard is None
        assert res.energies == plain.energies


# ---------------------------------------------------------------------------
# The LinAlgError repair of a full-update bond
# ---------------------------------------------------------------------------

def _failing_positive_fix(monkeypatch, fail_calls):
    """``positive_fix`` raising ``LinAlgError`` on its calls ``fail_calls``
    (1-based), as cuSOLVER's eigh does on a non-finite environment."""
    original = TFU.positive_fix
    calls = [0]

    def positive_fix(env):
        calls[0] += 1
        if calls[0] in fail_calls:
            raise torch.linalg.LinAlgError("injected eigh failure")
        return original(env)
    monkeypatch.setattr(TFU, "positive_fix", positive_fix)


class TestBondLinAlgError:
    def test_guarded_linalg_error_counts_as_nan_and_recovers(self,
                                                             monkeypatch):
        _failing_positive_fix(monkeypatch, {2})
        res = _tiny_full_ite(True)
        ev = [(e.site, e.cause, e.attempt, e.action)
              for e in res.guard.events]
        assert ev == [("full_update", "nan", 0, "detected"),
                      ("full_update", "nan", 1, "retry:exact_svd"),
                      ("full_update", "nan", 1, "recovered:exact_svd")]
        assert res.guard.counters["guard_nan_events"] == 1
        assert all(np.isfinite(e) for e in res.energies)

    def test_guarded_linalg_error_twice_is_exhausted(self, monkeypatch):
        _failing_positive_fix(monkeypatch, {1, 2})
        with pytest.raises(runtime_guard.GuardExhaustedError) as ei:
            _tiny_full_ite(True)
        assert (ei.value.site, ei.value.cause) == ("full_update", "nan")

    def test_unguarded_linalg_error_propagates(self, monkeypatch):
        _failing_positive_fix(monkeypatch, {1})
        with pytest.raises(torch.linalg.LinAlgError):
            _tiny_full_ite(None)


# ---------------------------------------------------------------------------
# Gradient-mode guarding: evaluation granularity
# ---------------------------------------------------------------------------

class TestGradModeGuard:
    def _grad(self, guard=None, svd=None):
        from repro_torch.core.vqe import vqe_energy_and_grad
        obs = tfi_hamiltonian(2, 2)
        upd = TP.QRUpdate(rank=2) if svd is None \
            else TP.QRUpdate(rank=2, svd=svd)
        con = BMPS(8) if svd is None else BMPS(8, svd=svd)
        th = np.random.default_rng(1).uniform(-0.3, 0.3, 4)
        return vqe_energy_and_grad(th, 2, 2, obs, upd, con, guard=guard,
                                   device=CPU)

    def test_guarded_grad_recovers_finite(self):
        g = runtime_guard.RuntimeGuard()
        with faults.armed("einsumsvd.result", nth=1, action="nan"):
            e, grad = self._grad(guard=g)
        assert torch.isfinite(e) and torch.isfinite(grad).all()
        assert g.report.counters.get("guard_nan_events", 0) == 1
        assert g.report.counters.get("guard_recovered", 0) == 1
        assert g.report.events[0].site == "vqe_grad"
        assert _actions(g.report)[-1] == "recovered:dense_kernel"
        clean_e, clean_g = self._grad()
        assert float(e) == float(clean_e)
        assert torch.equal(grad, clean_g)

    def test_unguarded_grad_propagates_nan(self):
        """Unguarded the corruption propagates: where the reference returns
        a NaN gradient, torch's SVD raises on the NaN it is handed."""
        with faults.armed("einsumsvd.result", nth=1, action="nan"):
            try:
                _, grad = self._grad()
            except torch.linalg.LinAlgError:
                return
        assert not torch.isfinite(grad).all()

    def test_randomized_svd_takes_exact_svd_rung_first(self):
        g = runtime_guard.RuntimeGuard()
        svd = RandomizedSVD(niter=2, oversample=4)
        with faults.armed("einsumsvd.result", nth=1, action="nan"):
            _, grad = self._grad(guard=g, svd=svd)
        assert torch.isfinite(grad).all()
        assert g.report.counters.get("guard_rung_exact_svd", 0) == 1

    def test_guarded_grad_exhaustion_is_structured(self):
        g = runtime_guard.RuntimeGuard()
        with faults.armed("einsumsvd.result", nth=1, action="nan",
                          times=10**6):
            with pytest.raises(runtime_guard.GuardExhaustedError) as ei:
                self._grad(guard=g)
        assert ei.value.site == "vqe_grad"
        assert g.report.counters.get("guard_exhausted", 0) == 1

    def test_guarded_batched_run_recovers(self):
        from repro_torch.core.vqe import run_vqe
        with faults.armed("einsumsvd.result", nth=1, action="nan"):
            r = run_vqe(2, 2, tfi_hamiltonian(2, 2), n_layers=1, max_bond=2,
                        maxiter=2, seed=0, method="adam", ensemble=2, lr=0.1,
                        guard=True, device=CPU)
        assert np.isfinite(r.energy)
        assert np.all(np.isfinite(r.ensemble_history))
        assert r.guard.counters.get("guard_recovered", 0) >= 1
        clean = run_vqe(2, 2, tfi_hamiltonian(2, 2), n_layers=1, max_bond=2,
                        maxiter=2, seed=0, method="adam", ensemble=2, lr=0.1,
                        device=CPU)
        np.testing.assert_array_equal(r.ensemble_thetas,
                                      clean.ensemble_thetas)


# ---------------------------------------------------------------------------
# Parity with the reference: the same armed fault, the same trail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action,nth", [("nan", 5), ("zero", 9)])
def test_guarded_ite_events_and_energies_match_the_reference(action, nth):
    """QR update with the randomized SVD on 2x2 TFI, three steps: the
    reference and the port count einsumsvd solves alike, so the Nth solve
    is the same solve in both and the ladders take the same rungs."""
    svd_r, svd_t = RRand(niter=2, oversample=4), RandomizedSVD(niter=2,
                                                               oversample=4)
    RF.arm("einsumsvd.result", nth=nth, action=action)
    ref = RI.ite_run(RP.computational_zeros(2, 2), r_tfi(2, 2), 0.05, 3,
                     RP.QRUpdate(rank=2, svd=svd_r), RBMPS(8, svd=svd_r),
                     measure_every=1, key=jax.random.PRNGKey(11), guard=True)
    faults.arm("einsumsvd.result", nth=nth, action=action)
    port = TI.ite_run(TP.computational_zeros(2, 2, device=CPU),
                      tfi_hamiltonian(2, 2), 0.05, 3,
                      TP.QRUpdate(rank=2, svd=svd_t), BMPS(8, svd=svd_t),
                      measure_every=1, key=JaxKey(11), guard=True)

    def trail(report):
        return [(e.site, e.cause, e.attempt, e.action) for e in report.events]
    assert trail(port.guard) == trail(ref.guard) != []
    assert port.guard.counters == ref.guard.counters
    np.testing.assert_allclose(port.energies, ref.energies, rtol=1e-8,
                               atol=0)
