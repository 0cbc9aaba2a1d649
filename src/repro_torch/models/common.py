"""Shared model machinery: parameter specs, the model Config, norms,
SwiGLU, rotary embeddings, the training loss and rematerialisation.

Counterpart of ``repro.models.common``.  Parameters are declared as trees
(nested dicts) of :class:`P_` leaves and drawn by :func:`init_params` from a
``torch.Generator`` with the reference's distributions; stacked layers keep
their leading axis, so a parameter tree converts key for key.  The
reference's logical axes, sharding rules and ``constrain`` have no
counterpart on one card.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tc

from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class P_:
    """A parameter leaf: shape and init (normal | zeros | ones | small)."""
    shape: Tuple[int, ...]
    init: str = "normal"
    dtype: Any = None             # defaults to the config's param dtype


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
                device=None) -> Dict[str, Any]:
    """Draw every leaf on ``device`` from ``generator`` (which must live on
    that device): normal * 0.02, small = normal * 0.006, zeros, ones.  The
    draws are f32, cast to the leaf's dtype; a leaf above
    ``WHOLE_DRAW_BYTES`` of f32 is drawn slice by slice along its leading
    axis."""
    device = resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * scale

    def draw(spec: P_):
        dtype = spec.dtype or param_dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        scale = 0.02 if spec.init == "normal" else 0.006
        if math.prod(spec.shape) * 4 <= WHOLE_DRAW_BYTES:
            return normal(spec.shape, scale).to(dtype)
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        row = math.prod(spec.shape[1:]) * 4
        step = max(1, SLICE_DRAW_BYTES // row)
        for i in range(0, spec.shape[0], step):
            rows = min(step, spec.shape[0] - i)
            out[i:i + rows] = normal((rows,) + spec.shape[1:], scale)
        return out

    out: Dict[str, Any] = {}
    for path, spec in tree_leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = draw(spec)
    return out


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
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))          # (half,)
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
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
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
