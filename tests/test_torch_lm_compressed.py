"""The port's compressed cross-pod training step on a (pod 2, data 2,
model 2) mesh of 8 gloo ranks (one thread each, one spawn, the group
joined through a file store), on the CPU.

``psum_compressed`` runs over the mesh's 2-rank ``pod`` groups and is held
to a numpy statement of the reference's formula (the reference cannot run
it on the CPU: XLA aborts on its 2x2x2 mesh): the mean and the new
residual equal it.  ``train_step_compressed`` of smollm-360m's f32 smoke
config is held to ``train_step`` on the same mesh under the reference's
bounds (``tests/test_extensions.py``): loss 1e-2 relative, parameters
5e-3.  Those bounds alone pass a broken step (one AdamW step moves an
element by about 1e-4 here), so each leaf's gradient, read back from the
new first moments, and its update are also held to the plain step's,
within limits set from measured runs; the same steps with a planted fault
(gradients zeroed or negated, no pod sum, no update) must fail them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import lm_params_to_numpy  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402

SHAPE = (2, 2, 2)
CELLS = SHAPE[1] * SHAPE[2]
LOSS_TOL, PARAM_TOL = 1e-2, 5e-3
# Per leaf, relative: measured at most 2.1e-2 (the gradient, at the head)
# and 8.3e-3 (the update); each planted fault reads 0.43 or more on one
# of them (no pod sum: 0.86 and 0.43)
GRAD_GAP, UPDATE_GAP = 0.1, 0.05
B1 = OptConfig().b1


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """One 8-rank spawn on (pod 2, data 2, model 2): the ``pod`` groups'
    ``psum_compressed`` and smollm's plain and compressed steps."""
    tmp = tmp_path_factory.mktemp("compressed")
    cfg = ranks.f32_config("smollm-360m")
    params = lm_params_to_numpy(build(cfg).init(0, "cpu"))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    case = {"arch": "smollm-360m", "overrides": {},
            "path": str(tmp / "case.npz"), "out": str(tmp / "out.npz")}
    opt = ranks.adamw_state(params)
    ranks.write_case(case["path"], params, opt, batch)
    ranks.spawn_in_background(ranks.run_compressed, 8,
                              (SHAPE, case, str(tmp), 1e-2))()
    return (tmp, ranks.read_out(case["out"]), dict(tree_leaves(params)),
            dict(tree_leaves(opt["mu"])))


@pytest.mark.parametrize("cell", range(CELLS))
def test_psum_compressed_two_ranks_matches_formula(eight_ranks, cell):
    tmp = eight_ranks[0]
    ins = [ranks.psum_inputs(pod, cell) for pod in range(2)]
    corrected = [g + e for g, e in ins]
    peak = np.float32(max(np.max(np.abs(c)) for c in corrected))
    scale = np.float32(peak / np.float32(127.0) + np.float32(1e-12))
    q = [np.clip(np.round(c / scale), -127, 127).astype(np.int8)
         for c in corrected]
    total = (q[0].astype(np.int32) + q[1].astype(np.int32))
    mean = total.astype(np.float32) * scale / np.float32(2)
    for pod in range(2):
        with np.load(tmp / f"psum_{pod}_{cell}.npz") as z:
            np.testing.assert_array_equal(z["mean"], mean)
            np.testing.assert_array_equal(
                z["err"], corrected[pod] - q[pod].astype(np.float32) * scale)


def _gaps(got, p0, mu0, fault=""):
    """Per leaf, relative Frobenius: the clipped gradient that the
    compressed step (``fault``'s, if given) fed AdamW against the plain
    step's, both read back from the new first moments (m = b1 m0 +
    (1 - b1) g), and its update against the plain update."""
    head = f"{fault}_" if fault else ""
    grad, update = {}, {}
    for k, mu in got["mu"].items():
        m0 = B1 * np.asarray(mu0[k], np.float64)
        grad[k] = _rel(got[head + "cmu"][k] - m0, mu - m0)
        update[k] = _rel(got[head + "cnew"][k] - p0[k], got["new"][k] - p0[k])
    return grad, update


def _measured_checks_pass(got, p0, mu0, fault=""):
    grad, update = _gaps(got, p0, mu0, fault)
    return max(grad.values()) <= GRAD_GAP and max(update.values()) <= UPDATE_GAP


def test_compressed_step_near_plain_step(eight_ranks):
    _, got, _, _ = eight_ranks
    # the loss is taken before the update: equal up to the pod average
    assert abs(got["closs"] - got["step_loss"]) <= LOSS_TOL * max(
        1.0, abs(got["step_loss"]))
    assert set(got["cnew"]) == set(got["new"])
    gap = max(np.max(np.abs(got["cnew"][k] - got["new"][k]))
              for k in got["new"])
    assert gap < PARAM_TOL, gap


def test_compressed_step_gradients_and_updates_near_plain(eight_ranks):
    _, got, p0, mu0 = eight_ranks
    assert set(got["cmu"]) == set(got["mu"]) == set(got["new"])
    assert _measured_checks_pass(got, p0, mu0), _gaps(got, p0, mu0)


@pytest.mark.parametrize("fault", ranks.PLANTED_FAULTS)
def test_planted_fault_fails_measured_checks(eight_ranks, fault):
    _, got, p0, mu0 = eight_ranks
    assert not _measured_checks_pass(got, p0, mu0, fault)
