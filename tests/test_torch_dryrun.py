"""The port's dry-run on the CPU: ``launch.cost_analysis``'s counters,
``launch.mesh.make_fake_mesh`` and ``launch.dryrun``'s cells.

The counters on hand-built collectives of known sizes on a fake (2, 2)
world (the counterpart of ``tests/test_runtime.py``'s
``test_collective_bytes_parses``): an all-gather, an all-reduce, a
reduce-scatter and an all-to-all, each ``DTensor`` redistribute counted
once at its output's bytes; ``DTensor``'s all-gather-plus-chunk fallback
of a ``cpu`` mesh counted as the all-to-all it stands for, equal to a
hand-built ``all_to_all_single`` of the same tensor; a collective of none
of the five kinds raising.  Flops equal ``FlopCounterMode``'s on one
device, bytes accessed and temporaries count as documented.  Then the
smoke cells (``smoke_train``, ``smoke_prefill``, ``smoke_decode``), one
per family, on fake (2, 2) and (2, 2, 2) worlds (see :data:`CELLS`), the
reference's two skip rules, and the PEPS cells recorded ``not_ported``.
The fake-world counts equal a real 4-rank gloo step's on rank 0 in
``tests/test_torch_lm_sharded.py``.
"""
import dataclasses
import math
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard)

from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_fake_mesh  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

# one architecture per family
FAMILIES = {"dense": "qwen3-4b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
            "vlm": "qwen2-vl-72b", "encdec": "whisper-large-v3"}
# (family, shape, fake mesh): one cell a family, every kind on (data 2,
# model 2) and the prefill and decode on (pod 2, data 2, model 2); the
# hybrid's train cell on (2, 2) runs in tests/test_torch_lm_sharded.py,
# held there to a real gloo step.  Each
# cell's first step pays DTensor's sharding propagation of every op
# signature, which on three axes plans its redistributes by a graph
# search over the placements: a smoke train step there takes about a
# minute (the 2x16x16 cells of ``--all`` run every kind at published
# widths), and a mesh axis of size 1, as (2, 1, 2) has, makes even a
# prefill take a minute (DTensor's placements on a size-1 axis are all
# equivalent states of that search).
CELLS = [("moe", "smoke_train", (2, 2)), ("dense", "smoke_prefill", (2, 2)),
         ("ssm", "smoke_prefill", (2, 2)),
         ("encdec", "smoke_prefill", (2, 2, 2)),
         ("hybrid", "smoke_decode", (2, 2)),
         ("vlm", "smoke_decode", (2, 2, 2))]
F32 = 4


@pytest.fixture(scope="module")
def mesh():
    """A (data 2, model 2) cpu mesh of a fake 4-rank world, left at the
    end of the module."""
    dryrun._quiet_dtensor_warnings()
    yield make_fake_mesh((2, 2), "cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def _counted(fn, *args):
    return cost_analysis.run(fn, *args)[1]


def _only(cost, kind, nbytes):
    """``cost`` holds one op of ``kind`` of ``nbytes``, nothing else."""
    want_bytes = {k: 0 for k in cost_analysis.KINDS}
    want_counts = dict(want_bytes)
    want_bytes[kind], want_counts[kind] = nbytes, 1
    assert cost.collective_bytes == want_bytes
    assert cost.collective_counts == want_counts
    assert cost.collectives() == (nbytes, want_bytes, want_counts)


def test_all_gather_counted_at_its_output(mesh):
    x = DTensor.from_local(torch.ones(4, 6), mesh, [Shard(0), Replicate()])
    _only(_counted(lambda: x.redistribute(mesh, [Replicate()] * 2)),
          "all-gather", 8 * 6 * F32)


def test_all_reduce_counted_at_its_output(mesh):
    x = DTensor.from_local(torch.ones(8, 6), mesh, [Replicate(), Partial()])
    _only(_counted(lambda: x.redistribute(mesh, [Replicate()] * 2)),
          "all-reduce", 8 * 6 * F32)


def test_reduce_scatter_counted_at_its_output(mesh):
    x = DTensor.from_local(torch.ones(8, 6), mesh, [Replicate(), Partial()])
    _only(_counted(lambda: x.redistribute(mesh, [Replicate(), Shard(0)])),
          "reduce-scatter", 4 * 6 * F32)


def test_cpu_all_to_all_fallback_counts_as_all_to_all(mesh):
    """Shard(0) -> Shard(1) over ``model``: on a ``cpu`` mesh DTensor
    all-gathers and chunks; it is counted as one all-to-all of its
    output's bytes, as the hand-built all-to-all of the same tensor is,
    and nothing inside it is counted."""
    from torch.distributed import _functional_collectives as funcol
    local = torch.ones(4, 6)
    x = DTensor.from_local(local, mesh, [Replicate(), Shard(0)])
    cost = _counted(lambda: x.redistribute(mesh, [Replicate(), Shard(1)]))
    _only(cost, "all-to-all", 8 * 3 * F32)
    assert cost.bytes_accessed == 0 and cost.flops == 0
    direct = _counted(lambda: funcol.wait_tensor(funcol.all_to_all_single(
        local, None, None, (mesh, 1))))
    _only(direct, "all-to-all", 8 * 3 * F32)


def test_unknown_collective_raises(mesh):
    from torch.distributed import _functional_collectives as funcol
    with pytest.raises(cost_analysis.UnknownCollective, match="broadcast"):
        _counted(lambda: funcol.broadcast(torch.ones(3), 0, (mesh, 0)))


def test_flops_bytes_and_memory_of_plain_ops():
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    cost = _counted(lambda: (a @ b).t())        # the transpose is a view
    assert cost.flops == 2 * 4 * 8 * 3
    assert cost.bytes_accessed == (4 * 8 + 8 * 3 + 4 * 3) * F32
    assert cost.temp_bytes == 4 * 3 * F32

    def freed(x):
        for _ in range(5):
            y = x * 2
            z = y + 1
            del y, z
        return x.sum()
    # two of the ten temporaries alive at once, the result a scalar
    assert _counted(freed, torch.ones(100, 100)).temp_bytes == \
        2 * 100 * 100 * F32
    assert cost_analysis.run(freed, torch.ones(100, 100))[1].arg_bytes == \
        100 * 100 * F32


def test_flops_equal_flop_counter_mode():
    """On a plain (mesh=None) smoke step the counters' flops are
    ``FlopCounterMode``'s total."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import dispatch
    from repro_torch.optim.adamw import adamw_init
    cfg = dataclasses.replace(C.get_smoke("qwen3-4b"),
                              param_dtype=torch.float32)
    bundle = build(cfg)
    params = bundle.init(0, "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16)),
             "labels": torch.randint(0, cfg.vocab, (2, 16))}
    with dispatch.forced_dense():
        cost = _counted(bundle.train_step, params, adamw_init(params), batch)
        with FlopCounterMode(display=False) as counter:
            bundle.train_step(params, adamw_init(params), batch)
    assert cost.flops == counter.get_total_flops() > 0


def test_local_bytes_of_a_placed_tree(mesh):
    x = DTensor.from_local(torch.ones(4, 6), mesh, [Shard(0), Replicate()])
    tree = {"a": x, "b": [torch.ones(3, dtype=torch.bfloat16)], "c": 7}
    assert cost_analysis.local_bytes(tree) == 4 * 6 * F32 + 3 * 2


@pytest.mark.parametrize("family,shape,mesh_shape", CELLS, ids=[
    f"{f}-{s}-{'x'.join(map(str, m))}" for f, s, m in CELLS])
def test_smoke_cell(mesh, family, shape, mesh_shape):
    """A smoke cell on a fake world: its row, with counts of this rank's
    step and the roofline's terms from them."""
    arch = FAMILIES[family]
    cfg = C.get_smoke(arch)
    rec = dryrun.run_lm_cell(arch, shape, False, verbose=False,
                             mesh_shape=mesh_shape, config=cfg)
    assert rec["status"] == "ok", rec
    assert rec["mesh"] == "x".join(map(str, mesh_shape))
    assert rec["chips"] == math.prod(mesh_shape)
    assert rec["per_device_flops"] > 0 and rec["per_device_bytes"] > 0
    assert rec["arg_bytes_per_device"] > 0 and rec["temp_bytes_per_device"] > 0
    assert set(rec["collective_counts"]) == set(cost_analysis.KINDS)
    assert rec["collective_bytes"] == sum(rec["collective_detail"].values())
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["step_s"] == max(rec["compute_s"], rec["memory_s"],
                                rec["collective_s"])
    assert rec["model_flops"] > 0 and 0 < rec["roofline_frac"]
    json.dumps(rec)


@pytest.mark.parametrize("arch,reason", [
    ("qwen3-4b", "full attention"),
    ("whisper-large-v3", "full attention"),
])
def test_skip_rules(arch, reason):
    """long_500k skips an architecture with full attention before any
    world is made."""
    rec = dryrun.run_cell(arch, "long_500k", True, verbose=False)
    assert rec["status"] == "skipped" and reason in rec["reason"]
    assert rec["mesh"] == "2x16x16"


def test_encdec_long_decode_rule():
    """The reference's second rule: the encdec's 448-token decoder, for
    a sub-quadratic whisper."""
    cfg = dataclasses.replace(C.get("whisper-large-v3"), sub_quadratic=True)
    rec = dryrun.run_lm_cell("whisper-large-v3", "long_500k", False,
                             verbose=False, config=cfg)
    assert rec["status"] == "skipped" and "448" in rec["reason"]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", dryrun.PEPS_SHAPES)
def test_peps_cells_not_ported(shape, multi_pod):
    rec = dryrun.run_cell("peps-rqc", shape, multi_pod, verbose=False)
    assert rec["status"] == "not_ported"
    assert "PEPS item 9" in rec["reason"]
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")


def test_main_records_and_resumes(tmp_path, capsys):
    """``main`` writes each cell's record to ``--out`` and exits by its
    status; the summary counts ``not_ported`` apart."""
    out = tmp_path / "dry.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "peps-rqc", "--shape", "contract",
                     "--out", str(out)])
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "granite-8b", "--shape", "long_500k",
                     "--out", str(out)])
    assert e.value.code == 0
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["not_ported", "skipped"]
    assert dryrun.summary(recs) == {"ok": 0, "skipped": 1, "not_ported": 1,
                                    "error": 0}


def test_fake_world_refuses_a_real_group(tmp_path):
    """A fake world cannot share a process with a real group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="gloo"):
            make_fake_mesh((2, 2), "cpu")
    finally:
        dist.destroy_process_group()
