"""The port's roofline arithmetic against the reference's, on the CPU.

``repro_torch.launch.roofline``'s ``param_count`` (dense and
``active_only``) and ``model_flops`` (train, prefill, decode at the shapes
of ``SHAPES``) equal ``repro.launch.roofline``'s exactly for all ten
architectures at their published widths; ``SHAPES`` equals the
reference's; ``Roofline.finish`` gives the reference's row on the same
counts once the port's card constants are set to the reference's TPU
ones for the test (the port holds the H100's, ``repro_torch.launch.mesh``);
``build_roofline`` takes a ``cost_analysis.Cost`` where the reference
takes ``cost_analysis()`` and HLO text.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as RC  # noqa: E402
from repro.launch import mesh as RM  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.models.model import SHAPES as R_SHAPES  # noqa: E402

from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.models.model import SHAPES  # noqa: E402

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's card constants set to the reference's for one test."""
    monkeypatch.setattr(M, "PEAK_FLOPS_BF16", RM.PEAK_FLOPS_BF16)
    monkeypatch.setattr(M, "HBM_BW", RM.HBM_BW)
    monkeypatch.setattr(M, "LINK_BW", RM.ICI_BW)


def test_shapes_match_reference():
    assert SHAPES == R_SHAPES


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_param_count_matches_reference(arch, active_only):
    got = R.param_count(C.get(arch), active_only=active_only)
    want = RR.param_count(RC.get(arch), active_only=active_only)
    assert type(got) is float and got == want


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", C.ARCHS)
def test_model_flops_match_reference(arch, kind):
    seq, gbatch, _ = SHAPES[KINDS[kind]]
    got = R.model_flops(C.get(arch), kind, seq, gbatch)
    assert got == RR.model_flops(RC.get(arch), kind, seq, gbatch)
    assert got > 0


def test_constants_are_the_h100s():
    """No TPU figure in the port: the H100 SXM's bf16 peak and HBM3
    bandwidth, and a bandwidth between cards above the TPU's ICI link."""
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW) == (989e12, 3.35e12)
    assert M.LINK_BW > RM.ICI_BW
    assert not {M.PEAK_FLOPS_BF16, M.HBM_BW, M.LINK_BW} & {
        RM.PEAK_FLOPS_BF16, RM.HBM_BW, RM.ICI_BW}


# per-device counts of a made-up cell, one per bottleneck
COUNTS = [
    (4.1e15, 1.6e14, 2.1e11),      # memory-bound
    (9.0e14, 1.0e11, 1.0e9),       # compute-bound
    (1.0e12, 1.0e10, 5.0e11),      # collective-bound
    (0.0, 0.0, 0.0),               # nothing counted
]


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: f"{c[0]:.0e}")
def test_finish_matches_reference(reference_constants, arch, counts):
    flops, nbytes, coll = counts
    detail = {"all-gather": int(coll) // 2, "reduce-scatter": int(coll) // 2}
    n = {"all-gather": 3, "reduce-scatter": 2}
    seq, gbatch, kind = SHAPES["train_4k"]
    common = dict(arch=arch, shape="train_4k", mesh="16x16", chips=256,
                  per_device_flops=flops, per_device_bytes=nbytes,
                  collective_bytes=float(coll), collective_detail=detail,
                  collective_counts=n, arg_bytes_per_device=1.5e9,
                  temp_bytes_per_device=2.5e9)
    got = R.Roofline(**common, model_flops=R.model_flops(
        C.get(arch), kind, seq, gbatch)).finish().row()
    want = RR.Roofline(**common, model_flops=RR.model_flops(
        RC.get(arch), kind, seq, gbatch)).finish().row()
    assert got == want
    assert [f.name for f in dataclasses.fields(R.Roofline)] == [
        f.name for f in dataclasses.fields(RR.Roofline)]


def test_build_roofline_reads_a_cost(reference_constants):
    """The reference's row from its cost_analysis dict and HLO text; the
    port's from a Cost with the same numbers."""
    cfg, rcfg = C.get("granite-8b"), RC.get("granite-8b")
    seq, gbatch, kind = SHAPES["prefill_32k"]
    hlo = "  %ag = bf16[2,128]{1,0} all-gather(%x), replica_groups={}\n" \
          "  %ar = f32[64]{0} all-reduce(%y), to_apply=%add\n"
    want = RR.build_roofline("granite-8b", "prefill_32k", "16x16", 256,
                             {"flops": 3e14, "bytes accessed": 2e12}, hlo,
                             rcfg, kind, seq, gbatch).row()
    cost = cost_analysis.Cost(
        flops=3e14, bytes_accessed=2e12,
        collective_bytes={"all-gather": 512, "all-reduce": 256},
        collective_counts={"all-gather": 1, "all-reduce": 1})
    got = R.build_roofline("granite-8b", "prefill_32k", "16x16", 256, cost,
                           cfg, kind, seq, gbatch).row()
    assert got == want
