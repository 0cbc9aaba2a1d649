"""Checkpoint/resume of the port's ITE and VQE runs, and the persistent
path cache (PEPS item 7).

The contract is the reference's (``docs/robustness.md``): a run killed
mid-evolution and called again with the same arguments and checkpoint
directory resumes from the latest published checkpoint and reproduces the
uninterrupted run.  Port to port that is bit for bit — ITE with the QR
update, with the randomized SVD's key stream, and with the full update's
environments and fidelity window; sequential SPSA and the adam/SPSA
ensembles — and SLSQP resumes as a warm restart.  Against the reference on
JAX-backed keys: the port's resumed run equals the reference's resumed run
at 1e-8, and a checkpoint the reference wrote resumes in the port to the
reference's uninterrupted energies at 1e-8.  The slow test kills a port
ITE subprocess with ``os._exit`` and resumes it in a second process.
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_helpers import CPU, JaxKey  # noqa: E402

from repro.core import ite as RI  # noqa: E402
from repro.core import peps as RP  # noqa: E402
from repro.core.bmps import BMPS as RBMPS  # noqa: E402
from repro.core.einsumsvd import RandomizedSVD as RRand  # noqa: E402
from repro.core.observable import tfi_hamiltonian as r_tfi  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.bmps import BMPS  # noqa: E402
from repro_torch.core.einsumsvd import RandomizedSVD, einsumsvd  # noqa: E402
from repro_torch.core.ite import ite_run  # noqa: E402
from repro_torch.core.keys import TorchKey  # noqa: E402
from repro_torch.core.observable import tfi_hamiltonian  # noqa: E402
from repro_torch.core.peps import FullUpdate, QRUpdate, \
    computational_zeros  # noqa: E402
from repro_torch.core.vqe import run_vqe, vqe_energy_peps  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
OBS = tfi_hamiltonian(2, 2)


def _zeros():
    return computational_zeros(2, 2, device=CPU)


def _by_step(result):
    return dict(zip(result.steps, result.energies))


class _Kill(Exception):
    pass


def _killer(at_step):
    def cb(step, e, state):
        if step >= at_step:
            raise _Kill(step)
    return cb


def _wait_for_checkpoint(ckdir, timeout=10.0):
    """The async writer may still be in flight when an in-process kill
    unwinds (a read-only glob: a CheckpointManager would sweep its tmp)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if any(p.suffix != ".tmp" and (p / "manifest.json").exists()
               for p in Path(ckdir).glob("step_*")):
            return
        time.sleep(0.05)
    raise AssertionError(f"no checkpoint appeared in {ckdir}")


def _kill_and_resume(ckdir, args, kill_at, every, **kw):
    with pytest.raises(_Kill):
        ite_run(*args, callback=_killer(kill_at), checkpoint_dir=str(ckdir),
                checkpoint_every=every, **kw)
    _wait_for_checkpoint(ckdir)
    return ite_run(*args, checkpoint_dir=str(ckdir), checkpoint_every=every,
                   **kw)


# ---------------------------------------------------------------------------
# ITE, port against port: bit for bit
# ---------------------------------------------------------------------------

class TestITEResume:
    def test_qr_update_resume_bit_identical(self, tmp_path):
        args = (_zeros(), OBS, 0.05, 6, QRUpdate(rank=2), BMPS(8))
        ref = ite_run(*args, measure_every=2)
        res = _kill_and_resume(tmp_path, args, 4, 2, measure_every=2)
        assert res.resumed_from == 2
        assert _by_step(res) == _by_step(ref)
        for a, b in zip(res.state.sites, ref.state.sites):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        assert torch.equal(res.state.log_scale, ref.state.log_scale)

    def test_randomized_svd_resume_preserves_key_stream(self, tmp_path):
        svd = RandomizedSVD(niter=2, oversample=4)
        args = (_zeros(), OBS, 0.05, 6, QRUpdate(rank=2, svd=svd),
                BMPS(8, svd=svd))
        ref = ite_run(*args, measure_every=2, key=TorchKey(5))
        res = _kill_and_resume(tmp_path, args, 4, 2, measure_every=2,
                               key=TorchKey(5))
        assert res.resumed_from is not None
        assert _by_step(res) == _by_step(ref)

    def test_full_update_resume_with_envs_and_fidelity_window(self,
                                                              tmp_path):
        """The full update carries the cached environments, the refresh
        counter and the undrained fidelity window through the snapshot."""
        args = (_zeros(), OBS, 0.05, 6,
                FullUpdate(rank=2, chi=8, env_refresh_every=3), BMPS(8))
        ref = ite_run(*args, measure_every=2)
        res = _kill_and_resume(tmp_path, args, 4, 3, measure_every=2)
        assert res.resumed_from == 3
        flat = CheckpointManager(tmp_path).load(3)
        assert any(k.startswith("envs_top/") for k in flat)
        assert len(flat["fid_window"]) > 0       # a mid-window snapshot
        assert _by_step(res) == _by_step(ref)
        assert dict(zip(res.steps, res.fidelities)) == \
            dict(zip(ref.steps, ref.fidelities))

    def test_planner_stats_cover_the_whole_logical_run(self, tmp_path):
        args = (_zeros(), OBS, 0.05, 6, QRUpdate(rank=2), BMPS(8))
        res = _kill_and_resume(tmp_path, args, 4, 2, measure_every=2)
        ref = ite_run(*args, measure_every=2)
        assert res.planner_stats["path_hits"] >= \
            ref.planner_stats["path_hits"]
        assert res.planner_stats["dense_gram_calls"] >= \
            ref.planner_stats["dense_gram_calls"]

    def test_resume_false_starts_fresh(self, tmp_path):
        args = (_zeros(), OBS, 0.05, 3, QRUpdate(rank=2), BMPS(8))
        ite_run(*args, measure_every=1, checkpoint_dir=str(tmp_path),
                checkpoint_every=1)
        res = ite_run(*args, measure_every=1, checkpoint_dir=str(tmp_path),
                      checkpoint_every=1, resume=False)
        assert res.resumed_from is None
        assert len(res.energies) == 3
        again = ite_run(*args, measure_every=1,
                        checkpoint_dir=str(tmp_path), checkpoint_every=1)
        assert again.resumed_from == 3 and again.energies == res.energies

    def test_snapshot_uses_the_reference_leaf_names(self, tmp_path):
        args = (_zeros(), OBS, 0.05, 2,
                FullUpdate(rank=2, chi=8, env_refresh_every=3), BMPS(8))
        ite_run(*args, measure_every=1, checkpoint_dir=str(tmp_path),
                checkpoint_every=2)
        flat = CheckpointManager(tmp_path).load(2)
        names = {k.split("/")[0] for k in flat}
        assert names == {"sites", "log_scale", "key", "energies",
                         "measured_at", "since_refresh", "fidelities",
                         "fid_window", "envs_top", "envs_bot", "meta_json"}
        assert flat["key"].dtype == np.uint64
        assert json.loads(str(flat["meta_json"][()]))["next_step"] == 2


# ---------------------------------------------------------------------------
# ITE against the reference, on JAX-backed keys
# ---------------------------------------------------------------------------

R_SVD = RRand(niter=2, oversample=4)
T_SVD = RandomizedSVD(niter=2, oversample=4)


def _ref_ite(steps, **kw):
    return RI.ite_run(RP.computational_zeros(2, 2), r_tfi(2, 2), 0.05, steps,
                      RP.QRUpdate(rank=2, svd=R_SVD), RBMPS(8, svd=R_SVD),
                      measure_every=2, key=jax.random.PRNGKey(9), **kw)


def _port_ite(steps, **kw):
    return ite_run(_zeros(), OBS, 0.05, steps, QRUpdate(rank=2, svd=T_SVD),
                   BMPS(8, svd=T_SVD), measure_every=2, key=JaxKey(9), **kw)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's uninterrupted 6-step run, and its 4-step run
    checkpointed every 2 steps, then resumed to 6 from a copy."""
    base = tmp_path_factory.mktemp("ref_ckpt")
    full = _ref_ite(6)
    _ref_ite(4, checkpoint_dir=str(base / "written"), checkpoint_every=2)
    shutil.copytree(base / "written", base / "resumed")
    resumed = _ref_ite(6, checkpoint_dir=str(base / "resumed"),
                       checkpoint_every=2)
    assert resumed.resumed_from == 4
    return full, resumed, base / "written"


def test_resumed_run_matches_the_reference_resumed_run(reference_runs,
                                                       tmp_path):
    _, ref_resumed, _ = reference_runs
    _port_ite(4, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    res = _port_ite(6, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert res.resumed_from == 4
    assert res.steps == ref_resumed.steps
    np.testing.assert_allclose(res.energies, ref_resumed.energies,
                               rtol=1e-8, atol=0)


def test_reference_checkpoint_resumes_in_the_port(reference_runs, tmp_path):
    """The reference's QR-update checkpoint (its raw uint32[2] key leaf
    rebuilt as a JaxKey) resumes in the port to the reference's
    uninterrupted energies."""
    ref_full, _, written = reference_runs
    shutil.copytree(written, tmp_path / "ckpt")
    res = _port_ite(6, checkpoint_dir=str(tmp_path / "ckpt"),
                    checkpoint_every=2)
    assert res.resumed_from == 4
    assert res.steps == ref_full.steps
    np.testing.assert_allclose(res.energies, ref_full.energies, rtol=1e-8,
                               atol=0)
    assert res.state.dtype == torch.complex128
    assert res.state.device.type == "cpu"


# ---------------------------------------------------------------------------
# VQE
# ---------------------------------------------------------------------------

VQE_KW = dict(n_layers=1, max_bond=2, device=CPU)


class TestVQEResume:
    def test_spsa_resume_bit_identical(self, tmp_path):
        kw = dict(VQE_KW, seed=3, method="spsa")
        ref = run_vqe(2, 2, OBS, maxiter=6, **kw)
        first = run_vqe(2, 2, OBS, maxiter=3, **kw,
                        checkpoint_dir=str(tmp_path), checkpoint_every=1)
        assert first.resumed_from is None
        res = run_vqe(2, 2, OBS, maxiter=6, **kw,
                      checkpoint_dir=str(tmp_path), checkpoint_every=1)
        assert res.resumed_from == 3
        assert res.history == ref.history
        np.testing.assert_array_equal(res.thetas, ref.thetas)
        assert res.energy == ref.energy

    def test_batched_adam_resume_bit_identical(self, tmp_path):
        kw = dict(VQE_KW, seed=0, method="adam", ensemble=3, lr=0.1)
        ref = run_vqe(2, 2, OBS, maxiter=6, **kw)
        run_vqe(2, 2, OBS, maxiter=3, **kw, checkpoint_dir=str(tmp_path),
                checkpoint_every=3)
        res = run_vqe(2, 2, OBS, maxiter=6, **kw,
                      checkpoint_dir=str(tmp_path), checkpoint_every=3)
        assert res.resumed_from == 3
        np.testing.assert_array_equal(res.ensemble_thetas,
                                      ref.ensemble_thetas)
        np.testing.assert_array_equal(res.ensemble_history,
                                      ref.ensemble_history)
        assert res.energy == ref.energy and res.history == ref.history

    def test_batched_spsa_resume_bit_identical(self, tmp_path):
        kw = dict(VQE_KW, seed=2, method="spsa", ensemble=2)
        ref = run_vqe(2, 2, OBS, maxiter=6, **kw)
        run_vqe(2, 2, OBS, maxiter=4, **kw, checkpoint_dir=str(tmp_path),
                checkpoint_every=2)
        res = run_vqe(2, 2, OBS, maxiter=6, **kw,
                      checkpoint_dir=str(tmp_path), checkpoint_every=2)
        assert res.resumed_from == 4
        np.testing.assert_array_equal(res.ensemble_thetas,
                                      ref.ensemble_thetas)
        np.testing.assert_array_equal(res.ensemble_history,
                                      ref.ensemble_history)

    def test_batched_resume_rejects_sequential_checkpoint(self, tmp_path):
        run_vqe(2, 2, OBS, maxiter=2, seed=3, method="spsa",
                checkpoint_dir=str(tmp_path), checkpoint_every=1, **VQE_KW)
        with pytest.raises(ValueError, match="not from a batched"):
            run_vqe(2, 2, OBS, maxiter=2, seed=3, method="adam", ensemble=2,
                    checkpoint_dir=str(tmp_path), checkpoint_every=1,
                    **VQE_KW)

    def test_slsqp_warm_restart(self, tmp_path):
        """SLSQP keeps its state inside scipy, so the documented resume is
        a warm restart: the saved history continues, the first new
        evaluation is at the saved angles, and the restart ends no higher
        than it started (docs/robustness.md)."""
        kw = dict(VQE_KW, seed=0, method="SLSQP")
        r1 = run_vqe(2, 2, OBS, maxiter=4, **kw,
                     checkpoint_dir=str(tmp_path), checkpoint_every=2)
        assert r1.resumed_from is None
        mgr = CheckpointManager(tmp_path)
        step = mgr.latest_step()
        saved = mgr.load(step)
        assert step == len(saved["history"]) and step <= len(r1.history)
        assert list(saved["history"]) == r1.history[:step]
        res = run_vqe(2, 2, OBS, maxiter=4, **kw,
                      checkpoint_dir=str(tmp_path), checkpoint_every=2)
        assert res.resumed_from == step
        assert res.history[:step] == r1.history[:step]
        start = float(vqe_energy_peps(saved["x"], 2, 2, OBS, QRUpdate(rank=2),
                                      BMPS(4), TorchKey(77), device=CPU))
        assert res.history[step] == start
        assert np.isfinite(res.energy) and len(res.history) > step + 1
        assert res.energy <= start + 1e-9


# ---------------------------------------------------------------------------
# The persistent path cache
# ---------------------------------------------------------------------------

class TestPersistentPathCache:
    def _warm(self):
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.standard_normal((8, 8, 4)))
        b = torch.from_numpy(rng.standard_normal((4, 8, 8)))
        return einsumsvd(RandomizedSVD(), [a, b], ["abk", "kcd"], "ab", "cd",
                         6, key=TorchKey(0))

    def test_roundtrip_gives_zero_misses(self, tmp_path):
        planner.clear()
        self._warm()
        f = tmp_path / "paths.json"
        n = planner.save_path_cache(str(f))
        assert n == planner.stats()["path_cache_size"] > 0
        planner.clear()
        assert planner.load_path_cache(str(f)) == n
        before = planner.stats()
        self._warm()
        delta = planner.stats_since(before)
        assert delta["path_misses"] == 0
        assert delta["path_hits"] > 0
        assert planner.stats()["path_preloaded"] == n

    def test_missing_file_is_a_silent_cold_start(self, tmp_path):
        assert planner.load_path_cache(str(tmp_path / "nope.json")) == 0

    def test_truncated_file_warns_and_cold_starts(self, tmp_path):
        planner.clear()
        self._warm()
        f = tmp_path / "paths.json"
        planner.save_path_cache(str(f))
        f.write_text(f.read_text()[: f.stat().st_size // 2])
        planner.clear()
        with pytest.warns(RuntimeWarning, match="cold start"):
            assert planner.load_path_cache(str(f)) == 0
        assert planner.stats()["path_cache_size"] == 0

    def test_checksum_mismatch_rejected(self, tmp_path):
        planner.clear()
        self._warm()
        f = tmp_path / "paths.json"
        planner.save_path_cache(str(f))
        payload = json.loads(f.read_text())
        payload["entries"][0][0] = "zz->z"    # tamper without re-checksumming
        f.write_text(json.dumps(payload))
        planner.clear()
        with pytest.warns(RuntimeWarning, match="checksum"):
            assert planner.load_path_cache(str(f)) == 0

    def test_unknown_format_version_rejected(self, tmp_path):
        f = tmp_path / "paths.json"
        f.write_text(json.dumps({"format": 99, "checksum": "", "entries": []}))
        with pytest.warns(RuntimeWarning, match="format"):
            assert planner.load_path_cache(str(f)) == 0


# ---------------------------------------------------------------------------
# A real kill: os._exit mid-run in a subprocess, resumed in a second one
# ---------------------------------------------------------------------------

ITE_SCRIPT = r"""
import json, os, sys
from repro_torch.core.bmps import BMPS
from repro_torch.core.einsumsvd import RandomizedSVD
from repro_torch.core.ite import ite_run
from repro_torch.core.observable import tfi_hamiltonian
from repro_torch.core.peps import QRUpdate, computational_zeros

log, ckpt, kill_at = sys.argv[1], sys.argv[2], int(sys.argv[3])
svd = RandomizedSVD(niter=2, oversample=4)

def cb(step, e, state):
    with open(log, "a") as f:
        f.write(json.dumps({"step": step, "energy": e}) + "\n")
    if kill_at and step >= kill_at:
        os._exit(42)

res = ite_run(computational_zeros(2, 2, device="cpu"), tfi_hamiltonian(2, 2),
              0.05, 8, QRUpdate(rank=2, svd=svd), BMPS(8, svd=svd),
              measure_every=2, callback=cb, checkpoint_dir=(ckpt or None),
              checkpoint_every=2)
print("RESUMED_FROM", res.resumed_from)
"""


def _run_script(tmp_path, args, expect_rc=0):
    script = tmp_path / "chaos.py"
    script.write_text(ITE_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(script)] + [str(a) for a in args],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == expect_rc, (
        f"rc={res.returncode}\nstdout:{res.stdout[-2000:]}\n"
        f"stderr:{res.stderr[-2000:]}")
    return res


def _log_dict(log):
    out = {}
    for line in Path(log).read_text().splitlines():
        rec = json.loads(line)
        if rec["step"] in out:   # measured again after the resume
            assert out[rec["step"]] == rec["energy"]
        out[rec["step"]] = rec["energy"]
    return out


@pytest.mark.slow
def test_chaos_kill_resume_ite_subprocess(tmp_path):
    """A port ITE killed with os._exit(42) at the step-6 measurement; the
    resumed process reproduces every energy of the uninterrupted run."""
    ref_log, got_log = tmp_path / "ref.jsonl", tmp_path / "got.jsonl"
    ck = tmp_path / "ckpt"
    _run_script(tmp_path, [ref_log, "", 0])
    _run_script(tmp_path, [got_log, ck, 6], expect_rc=42)
    res = _run_script(tmp_path, [got_log, ck, 0])
    assert "RESUMED_FROM None" not in res.stdout
    assert _log_dict(got_log) == _log_dict(ref_log)
