"""The port's LM launcher (``repro_torch.launch.train``) and its data
pipeline, on the CPU.

``SyntheticLM`` batches equal the reference's bit for bit; the launcher
trains smollm-360m's smoke config with falling losses; a run checkpointed
and resumed in process, and a run killed with ``os._exit(42)`` and resumed
in subprocesses, repeat the uninterrupted run's losses bit for bit; the
launcher's checkpoints hold ``opt_state_to_numpy``'s layout; the vlm's and
the encdec's step batches are the reference launcher's; a missing card
(without ``--device``) raises.

``--mesh 2x2 --device cpu`` starts 4 gloo ranks: at the launcher's
default batch (8 x 64 tokens) its losses are within 1e-4 (relative) of the
``--mesh 1x1`` run's, and a 1x1 checkpoint resumed on 2x2 continues within
1e-4 of a 1x1 continuation (the reference's elastic restore, where the
reference checks finiteness).  The smoke config is bf16: the model axis
sums bf16 partial outputs of the head- and MLP-split projections and the
data axis sums bf16 partial gradients (as the reference's GSPMD program
does), which puts the losses up to 1.9e-4 apart in absolute terms (4e-5
relative) in four steps.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, _flatten  # noqa: E402
from repro_torch.convert import (lm_params_to_numpy,  # noqa: E402
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RUN = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--batch", "4",
       "--seq", "32", "--checkpoint-every", "5"]
STEPS = 16


def _losses(log):
    return {rec["step"]: rec["loss"] for rec in
            map(json.loads, Path(log).read_text().splitlines())}


@pytest.mark.parametrize("kw", [
    dict(vocab=256, seq_len=32, global_batch=4, seed=0),
    dict(vocab=151936, seq_len=64, global_batch=2, seed=5),
    dict(vocab=1000, seq_len=16, global_batch=8, seed=2, n_hosts=2, host_id=1),
], ids=["smoke", "qwen-vocab", "host-1-of-2"])
def test_batch_at_equals_reference(kw):
    pipeline = pytest.importorskip("repro.data.pipeline")
    ours = SyntheticLM(DataConfig(**kw))
    ref = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    for step in (0, 7, 123):
        got, want = ours.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_iterate_yields_batch_at_in_order():
    data = SyntheticLM(DataConfig(vocab=256, seq_len=8, global_batch=2))
    it = data.iterate(start_step=5)
    for step in (5, 6, 7):
        got = next(it)
        np.testing.assert_array_equal(got["tokens"],
                                      data.batch_at(step)["tokens"])
    it.close()


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """16 steps in process, without checkpoints."""
    log = tmp_path_factory.mktemp("plain") / "log.jsonl"
    train.main(RUN + ["--steps", str(STEPS), "--log-file", str(log)])
    return _losses(log)


def test_losses_fall(uninterrupted):
    losses = [uninterrupted[s] for s in range(STEPS)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.2, losses


def test_checkpoint_and_resume_in_process(uninterrupted, tmp_path):
    """10 steps with a checkpoint every 5, then a run to 16 from the newest
    checkpoint: every loss is the uninterrupted run's, bit for bit; the
    checkpoint holds the parameters the first run returned and an AdamW
    state in ``opt_state_to_numpy``'s layout."""
    ck, log = tmp_path / "ckpt", tmp_path / "log.jsonl"
    params = train.main(RUN + ["--steps", "10", "--checkpoint-dir", str(ck),
                               "--log-file", str(log)])
    manager = CheckpointManager(ck)
    assert manager.latest_step() == 10
    flat = manager.load(10)
    want = _flatten({"params": lm_params_to_numpy(params),
                     "opt": opt_state_to_numpy(adamw_init(params))})
    assert flat.keys() == want.keys()
    for key, arr in flat.items():
        assert arr.shape == want[key].shape, key
        if key.startswith("params/"):
            np.testing.assert_array_equal(arr, want[key])
    tree = train._unflatten(flat)
    opt = opt_state_from_numpy(tree["opt"], device="cpu")
    assert int(opt["count"]) == 10
    assert opt["mu"]["embed"].dtype == torch.float32

    res = train.main(RUN + ["--steps", str(STEPS), "--checkpoint-dir", str(ck),
                            "--log-file", str(log)])
    got = _losses(log)
    assert sorted(got) == list(range(STEPS))
    assert got == uninterrupted
    assert res["embed"].shape == params["embed"].shape


def _run(args, expect_rc=0):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                         + RUN + args, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == expect_rc, (
        f"rc={res.returncode}\nstdout:{res.stdout[-2000:]}\n"
        f"stderr:{res.stderr[-2000:]}")
    return res


def test_chaos_kill_and_resume_subprocess(tmp_path):
    """The reference's recipe: an uninterrupted run; a run killed with
    os._exit(42) after step 12 with checkpoints every 5; its resume from
    step 10.  The overlapping losses are bit for bit the same."""
    log_a, log_b, ck = tmp_path / "a.jsonl", tmp_path / "b.jsonl", tmp_path / "ck"
    _run(["--steps", str(STEPS), "--log-file", str(log_a)])
    _run(["--steps", str(STEPS), "--checkpoint-dir", str(ck), "--log-file",
          str(log_b), "--simulate-failure", "12"], expect_rc=42)
    assert sorted(_losses(log_b)) == list(range(12))
    res = _run(["--steps", str(STEPS), "--checkpoint-dir", str(ck),
                "--log-file", str(log_b)])
    assert "resuming from checkpoint step 10" in res.stdout
    ref = _losses(log_a)
    got = {}
    for line in log_b.read_text().splitlines():
        rec = json.loads(line)
        if rec["step"] in got:      # steps 10 and 11 ran twice
            assert got[rec["step"]] == rec["loss"]
        got[rec["step"]] = rec["loss"]
    assert got == ref


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-large-v3"])
def test_step_batch_and_two_steps(arch, tmp_path):
    """The vlm's positions and the encdec's frames are the reference
    launcher's; two steps train to finite losses."""
    cfg = C.get_smoke(arch)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    batch = train.step_batch(cfg, data, 3, torch.device("cpu"))
    if cfg.family == "vlm":
        assert torch.equal(batch["positions"],
                           torch.arange(16, dtype=torch.int32).expand(3, 2, 16))
    else:
        want = np.random.default_rng(3).standard_normal(
            (2, cfg.enc_frames, cfg.d_model), dtype=np.float32)
        np.testing.assert_array_equal(batch["frames"].numpy(), want)
    log = tmp_path / "log.jsonl"
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "16", "--log-file", str(log)])
    assert all(np.isfinite(v) for v in _losses(log).values())


MESH_TOL = 1e-4
MESH_RUN = ["--arch", "smollm-360m", "--smoke", "--device", "cpu"]


def _close(got, want):
    assert set(got) == set(want)
    for step in want:
        assert abs(got[step] - want[step]) <= MESH_TOL * abs(want[step]), \
            (step, got[step], want[step])


def test_mesh_2x2_cpu_matches_1x1(tmp_path):
    logs = {mesh: tmp_path / f"{mesh}.jsonl" for mesh in ("1x1", "2x2")}
    for mesh, log in logs.items():
        params = train.main(MESH_RUN + ["--mesh", mesh, "--steps", "4",
                                        "--log-file", str(log)])
        assert (params is None) == (mesh == "2x2")
    want = _losses(logs["1x1"])
    assert set(want) == {0, 1, 2, 3}
    _close(_losses(logs["2x2"]), want)


def test_elastic_restore_1x1_to_2x2(tmp_path):
    """Checkpoint at step 10 on one device, resume on 2x2, killed by
    ``--simulate-failure 12`` once step 12's checkpoint is written (every
    rank ends, the launcher exits 42), resumed on 2x2 again from the
    checkpoint the four ranks wrote, to step 14: the losses of steps 10-13
    are those of a 1x1 resume from step 10."""
    base = MESH_RUN + ["--checkpoint-every", "2"]
    a, b = tmp_path / "a", tmp_path / "b"
    train.main(base + ["--steps", "10", "--checkpoint-dir", str(a)])
    shutil.copytree(a, b)
    logs = {name: tmp_path / f"{name}.jsonl" for name in ("a", "b")}
    train.main(base + ["--steps", "14", "--checkpoint-dir", str(a),
                       "--log-file", str(logs["a"])])
    mesh = base + ["--steps", "14", "--mesh", "2x2", "--checkpoint-dir",
                   str(b), "--log-file", str(logs["b"])]
    with pytest.raises(SystemExit) as killed:
        train.main(mesh + ["--simulate-failure", "12"])
    assert killed.value.code == 42
    assert CheckpointManager(b).latest_step() == 12
    assert set(_losses(logs["b"])) == {10, 11}
    train.main(mesh)
    want = _losses(logs["a"])
    assert set(want) == {10, 11, 12, 13}
    _close(_losses(logs["b"]), want)


def test_no_card_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
