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

``ModelBundle.input_specs`` of every architecture x every shape of
``SHAPES`` on (data 2, model 2) and (pod 2, data 1, model 2) fake worlds
(``make_fake_mesh``, in this process) against the reference's
``input_specs`` on fake XLA devices, in the same subprocess: the same
keys, shapes, dtypes and placements, every stand-in a ``meta`` tensor.
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
from repro_torch.models.model import build  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SHAPES = ((2, 2), (1, 4))
# (mesh index into SHAPES, batch)
LAYOUTS = ((0, 4), (1, 4), (0, 1))
MAX_SEQ = 2112
# f32 bytes: a leaf above 8 KB is drawn in slices of at most 2 KB
SMALL_DRAW = (8 * 1024, 2 * 1024)
# the meshes of the input_specs parity cases
IO_MESHES = [[2, 2], [2, 1, 2]]
IO_SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k",
                  "smoke_train", "smoke_prefill", "smoke_decode")
# Without JAX (a host with the port alone) the reference's half skips
HAVE_JAX = importlib.util.find_spec("jax") is not None

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro import configs
from repro.launch.mesh import make_mesh
from repro.models.model import SHAPES, build

layouts, io_meshes, out = (json.loads(sys.argv[1]), json.loads(sys.argv[2]),
                           sys.argv[3])


def axes(ns, ndim):
    spec = tuple(ns.spec) + (None,) * (ndim - len(tuple(ns.spec)))
    return [[] if p is None else [p] if isinstance(p, str) else list(p)
            for p in spec]


res = {"cache": {}, "io": {}}
for shape, m, batch in layouts:
    mesh = make_mesh(tuple(shape), ("data", "model"))
    for arch in configs.ARCHS:
        bundle = build(configs.get(arch), mesh)
        specs = bundle.cache_specs(batch, %d)
        res["cache"][f"{arch}/{m}/{batch}"] = {
            name: axes(ns, len(specs[name].shape))
            for name, ns in bundle.cache_shardings(batch, %d).items()}
# input_specs: every architecture x shape on each mesh
for shape in io_meshes:
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = make_mesh(tuple(shape), names)
    for arch in configs.ARCHS:
        bundle = build(configs.get(arch), mesh)
        for shape_name in SHAPES:
            io = bundle.input_specs(shape_name)
            entry = {"kind": io["kind"]}
            for key, value in io.items():
                if key == "kind" or key.endswith(("_sharding", "_shardings")):
                    continue
                for name, sds in (value.items() if isinstance(value, dict)
                                  else [(None, value)]):
                    label = key if name is None else f"{key}/{name}"
                    ns = (io[key + "_shardings"][name] if name is not None
                          and key + "_shardings" in io else
                          io.get(key + "_sharding"))
                    entry[label] = [list(sds.shape), str(sds.dtype),
                                    None if ns is None else
                                    axes(ns, len(sds.shape))]
            res["io"][f"{arch}/{'x'.join(map(str, shape))}/{shape_name}"] = \
                entry
with open(out, "w") as f:
    json.dump(res, f)
""" % (MAX_SEQ, MAX_SEQ)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """(the port's placements and draw flags, the reference's cache
    placements and input specs, or None without JAX)."""
    tmp = tmp_path_factory.mktemp("cache_shardings")
    script = tmp / "reference.py"
    script.write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    reference = None if not HAVE_JAX else subprocess.Popen(
        [sys.executable, str(script),
         json.dumps([[SHAPES[m], m, b] for m, b in LAYOUTS]),
         json.dumps(IO_MESHES), str(tmp / "ref.json")],
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


def _axes(sharding, ndim):
    """Per tensor axis, the mesh axes that split it, in mesh order."""
    names = sharding.mesh.mesh_dim_names
    return [[names[i] for i, pl in enumerate(sharding.placements)
             if pl.is_shard(dim)] for dim in range(ndim)]


def _io_entry(io):
    """``input_specs``' stand-ins as [shape, dtype, axes or None], keyed as
    the reference subprocess keys them."""
    entry = {"kind": io["kind"]}
    for key, value in io.items():
        if key == "kind" or key.endswith(("_sharding", "_shardings")):
            continue
        for name, t in (value.items() if isinstance(value, dict)
                        else [(None, value)]):
            label = key if name is None else f"{key}/{name}"
            ns = (io[key + "_shardings"][name] if name is not None
                  and key + "_shardings" in io else io.get(key + "_sharding"))
            assert t.device.type == "meta", label
            entry[label] = [list(t.shape), str(t.dtype).replace("torch.", ""),
                            None if ns is None else _axes(ns, t.dim())]
    return entry


@pytest.fixture(scope="module")
def port_io():
    """The port's ``input_specs`` of every architecture x shape on each of
    :data:`IO_MESHES`, each a fake world of its ranks in this process."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models.model import SHAPES as IO_SHAPES
    out = {}
    try:
        for shape in IO_MESHES:
            mesh = make_fake_mesh(shape, "cpu")
            for arch in C.ARCHS:
                bundle = build(C.get(arch), mesh=mesh)
                for name in IO_SHAPES:
                    out[f"{arch}/{'x'.join(map(str, shape))}/{name}"] = \
                        _io_entry(bundle.input_specs(name))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=lambda lay: f"{SHAPES[lay[0]]}-batch{lay[1]}")
@pytest.mark.parametrize("arch", C.ARCHS)
def test_cache_shardings_match_reference(placed, arch, layout):
    port, ref = placed
    if ref is None:
        pytest.skip("the reference needs JAX")
    key = f"{arch}/{layout[0]}/{layout[1]}"
    assert port["placements"][key] == ref["cache"][key]


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


@pytest.mark.parametrize("mesh", IO_MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("shape_name", IO_SHAPE_NAMES)
@pytest.mark.parametrize("arch", C.ARCHS)
def test_input_specs_match_reference(placed, port_io, arch, shape_name, mesh):
    """Shapes, dtypes and placements of every input of the shape."""
    ref = placed[1]
    if ref is None:
        pytest.skip("the reference needs JAX")
    key = f"{arch}/{'x'.join(map(str, mesh))}/{shape_name}"
    assert port_io[key] == ref["io"][key]


def test_input_specs_fallbacks(port_io):
    """long_500k's batch of 1 is whole; the vlm's positions split on their
    batch axis, the encdec's frames on axis 0; pods and data share the
    batch on (2, 1, 2)."""
    io = port_io["mamba2-2.7b/2x2/long_500k"]
    assert io["token"] == [[1, 1], "int32", [[], []]]
    io = port_io["qwen2-vl-72b/2x1x2/train_4k"]
    assert io["batch/positions"][2] == [[], ["pod", "data"], []]
    assert io["batch/tokens"][2] == [["pod", "data"], []]
    io = port_io["whisper-large-v3/2x2/prefill_32k"]
    assert io["frames"] == [[32, 32768, 1280], "float32",
                            [["data"], [], []]]
    assert port_io["qwen2-vl-72b/2x2/decode_32k"]["positions"] == [
        [3, 128, 1], "int32", None]
