"""The placements of the port's sharded decode cache and its sharded
parameter draw, on the CPU.

``ModelBundle.cache_shardings`` of every architecture at its published
shape, on (data 2, model 2) and (data 1, model 4) DeviceMeshes of four
gloo ranks, against the reference's ``cache_shardings`` built on a fake
4-device XLA mesh in a subprocess (no array is allocated on either side).
Batch 4 over 2,112 positions (a 2,048-token prompt and 64 decode steps);
smollm-360m's 5 KV heads take the kv_seq fallback on (1, 4) (the sequence
split over ``model``), and batch 1 on (2, 2) takes the batch fallback
(every cache whole along its batch).

``ModelBundle.init`` on a mesh draws each rank's shard alone: on every
rank it must equal ``distribute(init(seed), param_shardings())`` of the
one-device draw bit for bit, for every smoke config in f32, with the
draw's thresholds at their defaults and set so low that most leaves are
drawn slice by slice (a leaf split along its leading axis, as the
vocabulary of an embedding on (1, 4), keeps its part of each slice).
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as C  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SHAPES = ((2, 2), (1, 4))
# (mesh index into SHAPES, batch)
LAYOUTS = ((0, 4), (1, 4), (0, 1))
MAX_SEQ = 2112
# f32 bytes: a leaf above 8 KB is drawn in slices of at most 2 KB
SMALL_DRAW = (8 * 1024, 2 * 1024)
# Without JAX (a host with the port alone) the reference's half skips
HAVE_JAX = importlib.util.find_spec("jax") is not None

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro import configs
from repro.launch.mesh import make_mesh
from repro.models.model import build

layouts, out = json.loads(sys.argv[1]), sys.argv[2]
res = {}
for shape, m, batch in layouts:
    mesh = make_mesh(tuple(shape), ("data", "model"))
    for arch in configs.ARCHS:
        bundle = build(configs.get(arch), mesh)
        specs = bundle.cache_specs(batch, %d)
        entry = {}
        for name, ns in bundle.cache_shardings(batch, %d).items():
            spec = tuple(ns.spec) + (None,) * (
                len(specs[name].shape) - len(tuple(ns.spec)))
            entry[name] = [[] if p is None else [p] if isinstance(p, str)
                           else list(p) for p in spec]
        res[f"{arch}/{m}/{batch}"] = entry
with open(out, "w") as f:
    json.dump(res, f)
""" % (MAX_SEQ, MAX_SEQ)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """(the port's placements and draw flags, the reference's placements
    or None without JAX)."""
    tmp = tmp_path_factory.mktemp("cache_shardings")
    script = tmp / "reference.py"
    script.write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    reference = None if not HAVE_JAX else subprocess.Popen(
        [sys.executable, str(script),
         json.dumps([[SHAPES[m], m, b] for m, b in LAYOUTS]),
         str(tmp / "ref.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = tmp / "port.json"
    ranks.spawn_in_background(ranks.run_placements, 4, (
        SHAPES, LAYOUTS, C.ARCHS, str(out), SMALL_DRAW))()
    ref = None
    if reference is not None:
        _, err = reference.communicate()
        assert reference.returncode == 0, err[-3000:]
        ref = json.loads((tmp / "ref.json").read_text())
    return json.loads(out.read_text()), ref


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=lambda lay: f"{SHAPES[lay[0]]}-batch{lay[1]}")
@pytest.mark.parametrize("arch", C.ARCHS)
def test_cache_shardings_match_reference(placed, arch, layout):
    port, ref = placed
    if ref is None:
        pytest.skip("the reference needs JAX")
    key = f"{arch}/{layout[0]}/{layout[1]}"
    assert port["placements"][key] == ref[key]


def test_fallbacks_taken(placed):
    """The two fallbacks are among the layouts held above."""
    got = placed[0]["placements"]
    # smollm-360m's 5 KV heads: the sequence split over model on (1, 4)
    assert got["smollm-360m/1/4"]["k"] == [[], ["data"], ["model"], [], []]
    assert got["qwen3-4b/1/4"]["k"] == [[], ["data"], [], ["model"], []]
    # batch 1 on (2, 2): whole along the batch
    assert got["qwen3-4b/0/1"]["k"] == [[], [], [], ["model"], []]
    assert got["qwen3-4b/0/4"]["k"] == [[], ["data"], [], ["model"], []]
    assert got["mamba2-2.7b/0/1"]["ssm_h"] == [[], [], ["model"], [], []]


@pytest.mark.parametrize("draw", ["default", "sliced"])
@pytest.mark.parametrize("mesh", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_sharded_draw_is_the_distributed_draw(placed, arch, mesh, draw):
    assert placed[0]["draws"][f"{arch}/{mesh}/{draw}"] == [True] * 4
