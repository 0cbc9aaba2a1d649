"""The port's CheckpointManager against the reference's contract.

The round trips of ``tests/test_checkpoint.py`` (c64, c128, f64, i64 and
unicode leaves bit for bit; a bf16 tensor widened to f32 on disk and
narrowed back), torn writes and torn manifests under the
``checkpoint.write`` fault, the orphan sweep, GC, and the errors on a
missing step and a leaf mismatch.  Then the two packages' managers on one
directory: what the reference writes the port loads bit for bit, and the
other way round.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402
from repro.core import faults as RF  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import faults  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    RF.clear()
    yield
    faults.clear()
    RF.clear()


def _tree():
    return {
        "c128": np.array([[1 + 2j, -3.5 - 4j]], dtype=np.complex128),
        "c64": np.array([0.5 + 0.25j], dtype=np.complex64),
        "f64": np.linspace(0, 1, 5),
        "i64": np.arange(4),
        "meta": np.array(json.dumps({"step": 7, "name": "π-état"})),
    }


def _torch_tree():
    g = torch.Generator().manual_seed(3)
    c = torch.randn(3, 4, generator=g, dtype=torch.complex128)
    return {
        "sites/0_0": c,
        "sites/0_1": c.to(torch.complex64).conj(),    # a conj view
        "log_scale": torch.tensor(1.25, dtype=torch.float64),
        "count": torch.arange(3, dtype=torch.int32),
        "flags": torch.tensor([True, False]),
        "w": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16),
        "key": np.array([2**63 + 5], dtype=np.uint64),
        "meta_json": np.array(json.dumps({"next_step": 3})),
    }


def _assert_same(got, want):
    want = want.resolve_conj().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


class TestDtypeFidelity:
    def test_numpy_leaves_round_trip_bit_identically(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, _tree(), blocking=True)
        out = m.load(1)
        for k in ("c128", "c64", "f64", "i64"):
            _assert_same(out[k], _tree()[k])
        assert json.loads(str(out["meta"][()])) == {"step": 7,
                                                    "name": "π-état"}

    def test_torch_leaves_round_trip_bit_identically(self, tmp_path):
        tree = _torch_tree()
        m = CheckpointManager(tmp_path)
        m.save(2, tree, blocking=True)
        out = m.restore(2, {k: np.shape(v) for k, v in tree.items()})
        for k in ("sites/0_0", "sites/0_1", "log_scale", "count", "flags"):
            assert out[k].dtype == tree[k].dtype, k
            _assert_same(out[k], tree[k])
        assert out["w"].dtype == torch.bfloat16
        assert torch.equal(out["w"], tree["w"])
        _assert_same(m.load(2)["key"], tree["key"])
        assert (tmp_path / "step_00000002" / "sites__0_0.npy").exists()

    def test_bf16_is_widened_on_disk_and_narrowed_back(self, tmp_path):
        m = CheckpointManager(tmp_path)
        w = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
        m.save(1, {"w": w}, blocking=True)
        raw = np.load(tmp_path / "step_00000001" / "w.npy")
        assert raw.dtype == np.float32
        manifest = json.loads(
            (tmp_path / "step_00000001" / "manifest.json").read_text())
        assert manifest["leaves"]["w"] == {"file": "w.npy", "shape": [3],
                                           "dtype": "bfloat16"}
        assert m.load(1)["w"].dtype == np.float32
        back = m.restore(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"], w)

    def test_nested_trees_flatten_with_slashes(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, {"envs_top": [[np.ones(2)], [np.zeros(3)]],
                   "x": {"y": np.arange(2)}}, blocking=True)
        assert sorted(m.load(1)) == ["envs_top/0/0", "envs_top/1/0", "x/y"]

    def test_restore_rebuilds_the_target(self, tmp_path):
        m = CheckpointManager(tmp_path)
        tree = {"a": np.arange(3.0), "b": np.array([1 + 1j], np.complex128)}
        m.save(1, tree, blocking=True)
        out = m.restore(1, {"a": torch.zeros(3), "b": (1,)})
        assert list(out) == ["a", "b"]
        _assert_same(out["a"], tree["a"])
        _assert_same(out["b"], tree["b"])


class TestAtomicity:
    def test_torn_write_never_shadows_previous_step(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, _tree(), blocking=True)
        with faults.armed("checkpoint.write", action="torn"):
            m.save(2, _tree(), blocking=True)
        assert m.latest_step() == 1
        assert (tmp_path / "step_00000002.tmp").exists()
        _assert_same(m.load(1)["c128"], _tree()["c128"])

    def test_torn_final_manifest_is_skipped(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, _tree(), blocking=True)
        with faults.armed("checkpoint.write", action="torn_final"):
            m.save(2, _tree(), blocking=True)
        assert (tmp_path / "step_00000002" / "manifest.json").exists()
        assert m.all_steps() == [1]

    def test_init_sweeps_orphaned_tmp_dirs(self, tmp_path):
        m = CheckpointManager(tmp_path)
        with faults.armed("checkpoint.write", action="torn"):
            m.save(5, _tree(), blocking=True)
        orphan = tmp_path / "step_00000005.tmp"
        assert orphan.exists()
        CheckpointManager(tmp_path)    # a fresh manager (new process) sweeps
        assert not orphan.exists()

    def test_async_save_then_wait_is_durable(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(4, _torch_tree(), blocking=False)
        m.wait()
        assert m.latest_step() == 4


class TestGCAndErrors:
    def test_gc_keeps_the_newest_n(self, tmp_path):
        m = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4, 5):
            m.save(s, _tree(), blocking=True)
        assert m.all_steps() == [4, 5]

    def test_interleaved_saves_retain_by_step_order(self, tmp_path):
        m = CheckpointManager(tmp_path, keep=3)
        for s in (10, 2, 30, 4):
            m.save(s, _tree(), blocking=True)
        assert m.all_steps() == [4, 10, 30]

    def test_missing_step_raises_a_clear_error(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, _tree(), blocking=True)
        with pytest.raises(FileNotFoundError, match=r"step 99.*available"):
            m.load(99)
        with pytest.raises(FileNotFoundError, match=r"step 99"):
            m.restore(99, {"a": np.zeros(1)})

    def test_leaf_mismatch_messages(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, {"a": np.zeros(3)}, blocking=True)
        with pytest.raises(KeyError, match="not in target tree"):
            m.restore(1, {"b": np.zeros(3)})
        with pytest.raises(ValueError, match="shape"):
            m.restore(1, {"a": torch.zeros(4)})
        m.save(2, {"a": np.zeros(3)}, blocking=True)
        with pytest.raises(KeyError, match="missing leaves"):
            m.restore(2, {"a": np.zeros(3), "extra": (1,)})


class TestAcrossPackages:
    def test_reference_checkpoint_loads_bit_identically(self, tmp_path):
        ml_dtypes = pytest.importorskip("ml_dtypes")
        tree = dict(_tree(), w=np.array([1.5, -2.25],
                                        dtype=ml_dtypes.bfloat16))
        RefManager(tmp_path).save(3, tree, blocking=True)
        m = CheckpointManager(tmp_path)
        assert m.latest_step() == 3
        out = m.load(3)
        for k in ("c128", "c64", "f64", "i64", "meta"):
            _assert_same(out[k], tree[k])
        w = m.restore(3, {k: np.shape(v) for k, v in tree.items()})["w"]
        assert w.dtype == torch.bfloat16
        assert w.float().tolist() == [1.5, -2.25]

    def test_port_checkpoint_loads_bit_identically_in_the_reference(
            self, tmp_path):
        pytest.importorskip("ml_dtypes")
        tree = _torch_tree()
        CheckpointManager(tmp_path).save(3, tree, blocking=True)
        out = RefManager(tmp_path).load(3)
        for k in ("sites/0_0", "sites/0_1", "log_scale", "count", "flags",
                  "key"):
            _assert_same(out[k], tree[k])
        assert str(out["w"].dtype) == "bfloat16"
        assert out["w"].astype(np.float32).tolist() == [1.5, -2.25, 3.0]
        assert str(out["meta_json"][()]) == str(tree["meta_json"][()])

    def test_torn_writes_of_either_package_are_skipped_by_the_other(
            self, tmp_path):
        RefManager(tmp_path).save(1, _tree(), blocking=True)
        with RF.armed("checkpoint.write", action="torn_final"):
            RefManager(tmp_path).save(2, _tree(), blocking=True)
        with faults.armed("checkpoint.write", action="torn_final"):
            CheckpointManager(tmp_path).save(3, _tree(), blocking=True)
        assert CheckpointManager(tmp_path).all_steps() == [1]
        assert RefManager(tmp_path).all_steps() == [1]
