"""Shared model machinery: parameter specs, the model Config, norms,
SwiGLU, rotary embeddings, the training loss and rematerialisation.

Counterpart of ``repro.models.common``.  Parameters are declared as trees
(nested dicts) of :class:`P_` leaves and drawn by :func:`init_params` from a
``torch.Generator`` with the reference's distributions; stacked layers keep
their leading axis, so a parameter tree converts key for key.

Each leaf also carries the reference's logical axis names, and a rules
table maps them to the axes of a ``torch.distributed`` ``DeviceMesh`` with
the reference's divisibility fallback (:func:`resolve_spec`): a sharded
model's parameters are ``DTensor``s with those placements, and
:func:`constrain` redistributes an activation that is a ``DTensor``
(the reference's ``with_sharding_constraint``).  Without a mesh nothing
is a ``DTensor`` and :func:`constrain` returns its input.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tc
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class P_:
    """A parameter leaf: shape, logical axis names (None: every axis
    replicated) and init (normal | zeros | ones | small)."""
    shape: Tuple[int, ...]
    logical: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"
    dtype: Any = None             # defaults to the config's param dtype

    def __post_init__(self):
        if self.logical is None:
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        if len(self.shape) != len(self.logical):
            raise ValueError(f"P_: shape {self.shape} and logical axes "
                             f"{self.logical} differ in length")


def tree_leaves(tree, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs in sorted-key order (the reference's
    flattening order of a dict tree)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pair for k in sorted(tree) for pair in tree_leaves(tree[k],
                                                                prefix + (k,))]


# A leaf whose f32 draw would take more than WHOLE_DRAW_BYTES is drawn in
# slices of its leading axis, each at most SLICE_DRAW_BYTES of f32 (or one
# index, if that is larger), straight into its tensor: Qwen3-30B-A3B's
# expert stacks, (48, 128, 2048, 768), would otherwise need a 38.7 GB f32
# temporary beside 61 GB of bf16 weights.  Every leaf of the dense, ssm and
# hybrid models served on the card (at most 3.6 GB of f32) is drawn whole,
# so their weights stay what they were.
WHOLE_DRAW_BYTES = 4 * 2**30
SLICE_DRAW_BYTES = 2**30


def init_params(specs, generator: torch.Generator, param_dtype=torch.float32,
                device=None, shardings=None) -> Dict[str, Any]:
    """Draw every leaf on ``device`` from ``generator`` (which must live on
    that device): normal * 0.02, small = normal * 0.006, zeros, ones.  The
    draws are f32, cast to the leaf's dtype; a leaf above
    ``WHOLE_DRAW_BYTES`` of f32 is drawn slice by slice along its leading
    axis.

    With ``shardings`` (a tree of :class:`NamedSharding`, as
    :func:`param_shardings` gives) each leaf is a ``DTensor`` holding only
    this rank's shard: the draws are the same calls in the same order,
    each rank keeps its own part of each, so the result is bit for bit
    ``distribute(init_params(specs, ...), shardings)`` without the whole
    tree on any rank."""
    device = resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * scale

    def draw(spec: P_, sharding):
        dtype = spec.dtype or param_dtype
        mine = (tuple(slice(None) for _ in spec.shape) if sharding is None
                else local_slices(spec.shape, sharding.placements,
                                  sharding.mesh))
        local = tuple(len(range(*s.indices(n)))
                      for s, n in zip(mine, spec.shape))
        if spec.init == "zeros":
            return torch.zeros(local, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(local, dtype=dtype, device=device)
        scale = 0.02 if spec.init == "normal" else 0.006
        if math.prod(spec.shape) * 4 <= WHOLE_DRAW_BYTES:
            return normal(spec.shape, scale)[mine].to(
                dtype, copy=sharding is not None)
        out = torch.empty(local, dtype=dtype, device=device)
        row = math.prod(spec.shape[1:]) * 4
        step = max(1, SLICE_DRAW_BYTES // row)
        lo, hi, _ = mine[0].indices(spec.shape[0])
        for i in range(0, spec.shape[0], step):
            rows = min(step, spec.shape[0] - i)
            part = normal((rows,) + spec.shape[1:], scale)
            a, b = max(i, lo), min(i + rows, hi)
            if a < b:
                out[a - lo:b - lo] = part[(slice(a - i, b - i),) + mine[1:]]
        return out

    out: Dict[str, Any] = {}
    for path, spec in tree_leaves(specs):
        sharding = None
        if shardings is not None:
            sharding = shardings
            for k in path:
                sharding = sharding[k]
        leaf = draw(spec, sharding)
        if sharding is not None:
            leaf = DTensor.from_local(leaf, sharding.mesh, sharding.placements,
                                      shape=torch.Size(spec.shape),
                                      stride=_contiguous(spec.shape))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _contiguous(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def take(tree, index):
    """Index every leaf of a parameter tree on its leading axes."""
    if isinstance(tree, dict):
        return {k: take(v, index) for k, v in tree.items()}
    return tree[index]


def unstack(tree) -> list:
    """A stacked parameter tree as the list of its trees along the leading
    axis, views made by one ``torch.unbind`` per leaf.  Under autograd the
    gradients of all of them come back as one stack per leaf, where
    indexing each layer with :func:`take` costs a zero-filled copy of the
    whole stacked leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

# the reference's rules: FSDP over 'data' (embed axis of weights), TP/EP
# over 'model'
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": "data",          # FSDP / ZeRO-3 weight sharding
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "expert_mlp": None,
    "vocab": "model",
    "seq": None,
    "kv_seq": None,
    "layers": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_bc": None,
    "conv": None,
    "frames": None,
    # activation-only axes
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
}


# an activation (B, S, D) split over the batch axes, its features whole
ACT_EMBED = ("batch", None, "act_embed")


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_size(mesh, axes) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh) -> tuple:
    """Logical axes -> one placement per mesh dimension, with the
    reference's divisibility fallback: a tensor axis takes the rule's mesh
    axes that the mesh has and no earlier axis took, if its length divides
    by their product, else it is replicated.  A tensor axis over two mesh
    axes (``batch`` over ``pod`` and ``data``) is ``Shard`` on both, split
    in mesh order as the reference's ``PartitionSpec(("pod", "data"))``.
    The rules are the reference's, :data:`DEFAULT_RULES`."""
    names = mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    used = set()
    for i, (dim, name) in enumerate(zip(shape, logical)):
        rule = DEFAULT_RULES.get(name) if name else None
        if rule is None:
            continue
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        axes = tuple(a for a in axes if a in names and a not in used)
        if axes and dim % _axes_size(mesh, axes) == 0:
            used.update(axes)
            for a in axes:
                placements[names.index(a)] = Shard(i)
    return tuple(placements)


class NamedSharding(NamedTuple):
    """Where a tensor's shards go: a ``DeviceMesh`` and one placement per
    mesh axis (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    placements: tuple


def param_shardings(specs, mesh):
    """The :class:`NamedSharding` of every leaf of ``specs`` on ``mesh``,
    as a tree."""
    if isinstance(specs, dict):
        return {k: param_shardings(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, resolve_spec(specs.shape, specs.logical, mesh))


def distribute(tree, shardings):
    """Full tensors onto their meshes: every leaf of ``tree`` as a
    ``DTensor`` with the placements of its :class:`NamedSharding` in
    ``shardings`` (a tree of the same keys).  Each rank keeps its own
    shards of the full tensor it holds, with no communication: every rank
    must hold the same full tree."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    return distribute_tensor(tree, shardings.mesh, shardings.placements,
                             src_data_rank=None)


def local_slices(shape: Sequence[int], placements, mesh) -> tuple:
    """This rank's slice of each axis of a tensor of ``shape`` placed by
    ``placements`` on ``mesh``: an axis split over several mesh axes is
    split in mesh order (the first the outermost), evenly, as
    :func:`resolve_spec` only splits axes that divide."""
    out = []
    for dim, n in enumerate(shape):
        index, parts = 0, 1
        for i, pl in enumerate(placements):
            if pl.is_shard(dim):
                size = mesh.size(i)
                index = index * size + mesh.get_local_rank(i)
                parts *= size
        block = n // parts
        out.append(slice(index * block, (index + 1) * block))
    return tuple(out)


def local_range(x, dim: int) -> Tuple[int, int]:
    """[start, stop) of this rank's block of axis ``dim`` of ``x`` (the
    whole axis for a plain tensor)."""
    if not isinstance(x, DTensor):
        return 0, x.shape[dim]
    s = local_slices(x.shape, x.placements, x.device_mesh)[dim]
    return s.start, s.stop


def slot(x, index):
    """``x[index]`` for an int or a tuple of ints on the leading axes.  On
    a ``DTensor`` whose indexed axes are whole, a ``DTensor`` over the same
    local storage (its placements moved down), so that writing into its
    local tensor writes into ``x``'s."""
    if not isinstance(x, DTensor):
        return x[index]
    index = index if isinstance(index, tuple) else (index,)
    k = len(index)
    if any(pl.is_shard() and pl.dim < k for pl in x.placements):
        raise ValueError(f"slot: the indexed axes of a {tuple(x.shape)} "
                         f"DTensor placed {tuple(x.placements)} are split")
    placements = tuple(Shard(pl.dim - k) if pl.is_shard() else pl
                       for pl in x.placements)
    return DTensor.from_local(x.to_local()[index], x.device_mesh, placements,
                              shape=x.shape[k:], stride=x.stride()[k:])


def assign(dst, src) -> None:
    """``dst[...] = src`` in place (cast to dst's dtype).  A ``DTensor``
    ``dst`` takes ``src`` redistributed to its placements into its local
    tensor: ``DTensor``'s own in-place indexing has no working rule in
    every release."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def replicating(x):
    """``implicit_replication`` (plain tensors among ``DTensor`` operands
    count as replicated) when ``x`` is a ``DTensor``, else a null
    context."""
    if not isinstance(x, DTensor):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def cache_shardings(specs, axes, mesh) -> Dict[str, NamedSharding]:
    """The reference's ``ModelBundle.cache_shardings``: each cache entry of
    ``specs`` (name -> spec with a ``shape``) placed by its logical
    ``axes`` (name -> axis names) with two fallbacks.  A KV cache whose
    ``kv_heads`` do not divide by ``model`` while its ``kv_seq`` does is
    split along the sequence over ``model`` instead (flash-decode style:
    the softmax statistics combined across ranks are small); a ``batch``
    that does not divide by the batch axes is whole."""
    sizes = mesh_sizes(mesh)
    m = sizes.get("model", 1)
    out = {}
    for name, spec in specs.items():
        logical = list(axes[name])
        if "kv_heads" in logical and m > 1:
            kv_i, seq_i = logical.index("kv_heads"), logical.index("kv_seq")
            if spec.shape[kv_i] % m and spec.shape[seq_i] % m == 0:
                logical[kv_i] = None
                logical[seq_i] = "act_heads"      # -> 'model'
        if "batch" in logical:
            b_i = logical.index("batch")
            if spec.shape[b_i] % _axes_size(mesh, batch_axes(mesh)):
                logical[b_i] = None
        out[name] = NamedSharding(mesh, resolve_spec(spec.shape, logical,
                                                     mesh))
    return out


def zero_cache(specs, axes, device=None, mesh=None) -> Dict[str, Any]:
    """A zero decode cache of ``specs`` (name -> spec with a ``shape`` and
    a ``dtype``; ``index`` becomes the int 0) on ``device``; on ``mesh``,
    each entry a ``DTensor`` placed by :func:`cache_shardings` of its
    logical ``axes``, each rank allocating its own block."""
    cache: Dict[str, Any] = {}
    placed = None if mesh is None else cache_shardings(specs, axes, mesh)
    device = resolve_device(device) if mesh is None else mesh_device(mesh)
    for name, spec in specs.items():
        if name == "index":
            continue
        if placed is None:
            cache[name] = torch.zeros(spec.shape, dtype=spec.dtype,
                                      device=device)
            continue
        ns = placed[name]
        local = tuple(s.stop - s.start for s in local_slices(
            spec.shape, ns.placements, mesh))
        cache[name] = DTensor.from_local(
            torch.zeros(local, dtype=spec.dtype, device=device), mesh,
            ns.placements, shape=torch.Size(spec.shape),
            stride=_contiguous(spec.shape))
    cache["index"] = 0
    return cache


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes a batch is split over: ``pod`` and ``data``, those the
    mesh has."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def constrain(x, logical: Sequence[Optional[str]]):
    """The reference's ``constrain``: ``x`` redistributed to the placements
    of its logical axes when it is a ``DTensor``, else ``x`` itself."""
    if not isinstance(x, DTensor):
        return x
    want = resolve_spec(x.shape, logical, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def local_call(fn: Callable, args: Sequence, out_placements):
    """``fn(*args)``, on each rank's local shards when an argument is a
    ``DTensor`` (``local_map`` with the arguments' own placements as its
    ``in_placements``): the counterpart of a ``shard_map`` region whose
    in-specs are the operands' shardings.  ``out_placements`` is the
    output's placements as a list (a tuple of lists for several outputs).
    An argument whole over a mesh axis that splits another one gets a
    gradient partial over that axis (each rank's slice contributes its
    part).  Without a ``DTensor`` among ``args`` this is ``fn(*args)``."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    split = {i for a in dts for i, pl in enumerate(a.placements)
             if pl.is_shard()}

    def grad(a):
        if not isinstance(a, DTensor):
            return None
        return [Partial() if i in split and not pl.is_shard() else pl
                for i, pl in enumerate(a.placements)]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(a.placements if isinstance(
                         a, DTensor) else None for a in args),
                     in_grad_placements=tuple(grad(a) for a in args),
                     device_mesh=dts[0].device_mesh)(*args)


class _PlacedReshape(torch.autograd.Function):
    """A ``DTensor`` reshape whose gradient is placed as its output was
    before it is reshaped back: the ops behind a reshape may hand back a
    gradient split along an axis that the reverse view cannot split."""

    @staticmethod
    def forward(ctx, x, shape):
        y = x.reshape(shape)
        # a gradient is never partial where its forward value was
        ctx.in_shape = x.shape
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl
                               for pl in y.placements)
        return y

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g.reshape(ctx.in_shape), None


def reshape(x, *shape: int):
    """``x.reshape(shape)``; for a ``DTensor``, with its gradient placed as
    the output (see :class:`_PlacedReshape`)."""
    if isinstance(x, DTensor):
        return _PlacedReshape.apply(x, shape)
    return x.reshape(shape)


def split_last(x, *sizes: int):
    """``x.reshape(*x.shape[:-1], *sizes)``.  A ``DTensor`` whose last
    axis is split over mesh axes that ``sizes[0]`` does not divide by
    (``DTensor`` can view a split axis only along whole blocks of its
    first factor) is first made whole along that axis."""
    if isinstance(x, DTensor):
        n = 1
        for i, pl in enumerate(x.placements):
            if pl.is_shard(x.dim() - 1):
                n *= x.device_mesh.size(i)
        if sizes[0] % n:
            x = unshard(x, -1)
    return reshape(x, *x.shape[:-1], *sizes)


def lookup(table, tokens):
    """``table[tokens]``: the rows of an embedding table.  On a mesh the
    lookup runs on each rank's tokens against the whole table (gathered
    at the region's boundary, its gradient reduce-scattered back), since
    the index ops' ``DTensor`` rules do not hold for a sharded table in
    every release."""
    if not isinstance(table, DTensor):
        return table[tokens]
    out = list(getattr(tokens, "placements",
                       [Replicate()] * table.device_mesh.ndim))
    return local_call(lambda t, i: t[i], (unshard(table, 0, 1), tokens), out)


def unshard(x, *dims: int):
    """``x`` with its tensor axes ``dims`` whole on every rank: a
    ``DTensor`` sharded along one of them is redistributed to replicate
    those mesh axes; anything else comes back as it is.  The models call it
    at an op whose ``DTensor`` rule cannot take a sharded operand axis."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim in dims
                 else pl for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab: int = 32000
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_impl: str = "chunked"            # chunked (flash-style) | naive
    attn_chunk: int = 2048
    layer_unroll: int = 1
    group_unroll: int = 1
    attn_unroll: bool = False
    mrope_sections: Optional[Tuple[int, int, int]] = None  # vlm
    # MoE
    moe_impl: str = "fsdp_gather"
    moe_psum_dtype: str = "f32"
    n_experts: int = 0
    top_k: int = 0
    d_expert_ff: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    norm_topk: bool = True
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_chunk: int = 128                  # SSD chunk length
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    # hybrid (zamba2)
    hybrid_group: int = 6                 # 1 shared attn per group
    # encdec (whisper)
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # numerics / training
    param_dtype: Any = torch.float32
    act_dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "nothing"
    sub_quadratic: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


# ---------------------------------------------------------------------------
# Norms / activations / rotary embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the sum of squares in f32, the scaling in x's dtype."""
    sumsq = x.float().square().sum(dim=-1)
    rs = torch.rsqrt(sumsq / x.shape[-1] + eps)
    return x * rs[..., None].to(x.dtype) * scale.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)


def _rope_freqs(d_half: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(d_half, dtype=torch.float32,
                                         device=device) / d_half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate-half by f32 angles ``ang`` (B, S, D / 2), in x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotate-half RoPE. x: (B, S, H, D), positions: (B, S) int."""
    half = x.shape[-1] // 2
    return _rotate(x, positions.float()[..., None]
                   * _rope_freqs(half, theta, x.device))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, D), positions: (3, B, S) int
    for (t, h, w); ``sections`` split the half-dim (sum == D // 2): each
    frequency slot takes its angle from the position stream of its
    section."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"apply_mrope: sections {tuple(sections)} sum to "
                         f"{sum(sections)}, not half the head dimension "
                         f"{half}")
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (half,)
    pos = positions.float()[sec_id]                         # (half, B, S)
    return _rotate(x, pos.movedim(0, -1) * _rope_freqs(half, theta, x.device))


# ---------------------------------------------------------------------------
# Training: loss and rematerialisation
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE: logits (B, S, V) of any float dtype, taken in
    f32 (logsumexp minus the gold logit); labels (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = unshard(logits, -1).gather(-1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matmuls without batch dimensions, recompute the rest."""
    return (tc.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else tc.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_policy(cfg: Config) -> Callable:
    """``cfg.remat_policy`` as the ``context_fn`` of a non-reentrant
    ``torch.utils.checkpoint``: ``"dots"`` saves the outputs of ``aten.mm``
    and ``aten.addmm`` (a 3-D activation times a 2-D weight reaches them)
    and recomputes everything else; any other policy (``"nothing"``) saves
    only the block's inputs."""
    if cfg.remat_policy == "dots":
        return functools.partial(tc.create_selective_checkpoint_contexts,
                                 _save_dots)
    return tc.noop_context_fn


def remat(fn: Callable, cfg: Config) -> Callable:
    """``fn`` under one non-reentrant checkpoint with ``cfg``'s policy when
    ``cfg.remat`` is set and autograd is recording, else ``fn`` itself.

    Non-reentrant: the first forward and the backward's recompute both run
    with grad enabled on operands that require it, so a kernel site routes
    both to its dense version (a reentrant checkpoint would run the first
    forward under no_grad, through the kernel, and recompute densely)."""
    if not cfg.remat:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return tc.checkpoint(fn, *args, use_reentrant=False,
                             context_fn=checkpoint_policy(cfg))
    return wrapped
