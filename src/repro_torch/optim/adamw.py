"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro.optim.adamw``.  Parameters, gradients and moments are
a tensor, or nested dicts and lists of tensors (an LM's parameter tree, a
VQE's flat list), taken leaf by leaf in the reference's pytree order: dict
keys sorted, lists in order.
The update computes in each *moment*'s dtype: float32 moments by default,
``moment_dtype=torch.float64`` in :func:`adamw_init` for full-precision
optimization (the adam optimizer of
:mod:`repro_torch.core.vqe` runs it in float64).

On a mesh the leaves are ``DTensor``s, each gradient and moment placed as
its parameter (ZeRO-style: the moments are as distributed as the
parameters).  The clipping norm is that of the whole gradient, and the
elementwise update runs on each rank's local shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate


# A donated update (see adamw_update) writes a leaf in slices of at most
# this many elements along its leading axis.
DONATE_SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _leaves(tree):
    """The tensors of ``tree`` in the reference's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _like(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`_leaves` order) in
    place of its tensors; tuples come back as lists."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            built = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [rebuild(sub) for sub in node]
        return next(it)
    return rebuild(tree)


def _local(t):
    """A ``DTensor``'s local shard; any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _placed_as(like, t):
    """``t``, a local shard, as a ``DTensor`` placed as ``like`` where
    ``like`` is one; else ``t``."""
    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              shape=like.shape, stride=like.stride())


def adamw_init(params, moment_dtype=torch.float32) -> Dict[str, Any]:
    """Zero moments of ``moment_dtype`` beside each parameter (placed as it
    on a mesh), and a zero int32 step count (replicated on a mesh).  On
    ``meta`` parameters this is the reference's ``abstract_opt_state``:
    shapes and dtypes, nothing allocated."""
    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=moment_dtype)
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    first = _leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):
        mesh = first.device_mesh
        count = DTensor.from_local(
            torch.zeros((), dtype=torch.int32, device=first.to_local().device),
            mesh, [Replicate()] * mesh.ndim)
    return {"mu": _like(params, [zeros(p) for p in _leaves(params)]),
            "nu": _like(params, [zeros(p) for p in _leaves(params)]),
            "count": count}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each promoted to at least
    float32 (never truncated: float64 gradients keep a float64 norm).  A
    ``DTensor`` leaf counts whole, as on one device."""
    sq = []
    for x in _leaves(tree):
        s = torch.sum(torch.square(
            x.to(torch.promote_types(x.dtype, torch.float32))))
        sq.append(s.full_tensor() if isinstance(s, DTensor) else s)
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_update(grads, state, params, cfg: OptConfig, lr=None,
                 donate: bool = False):
    """Returns ``(new_params, new_state, metrics)``; the update computes in
    each moment leaf's dtype.

    ``donate=True`` is the counterpart of the reference launcher's
    ``donate_argnums``: the new values (the same ones) are written into the
    old parameter and moment tensors, a slice of at most
    ``DONATE_SLICE_ELEMENTS`` along the leading axis at a time, and the
    returned trees are ``params`` and ``state``'s own, so an update holds
    the temporaries of one slice, not a second copy of the parameters and
    moments (Qwen3-4B's stacked MLP weights are 3.3 GiB of f32 each).

    ``DTensor`` leaves (each gradient and moment placed as its parameter)
    are updated on their local shards and come back placed as before."""
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count = _local(state["count"]) + 1

    def update(g, m, v, p):
        dt = m.dtype
        c1 = 1.0 - torch.pow(cfg.b1, count.to(dt))
        c2 = 1.0 - torch.pow(cfg.b2, count.to(dt))
        gd = g.to(dt) * scale.to(dt)
        m_new = cfg.b1 * m + (1 - cfg.b1) * gd
        v_new = cfg.b2 * v + (1 - cfg.b2) * gd * gd
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        pd = p.to(dt)
        p_new = pd - lr * (step + cfg.weight_decay * pd)
        return p_new.to(p.dtype), m_new, v_new

    new_p, new_m, new_v = [], [], []
    for placed in zip(_leaves(grads), _leaves(state["mu"]),
                      _leaves(state["nu"]), _leaves(params)):
        leaf = [_local(t) for t in placed]
        if not donate:
            p_new, m_new, v_new = update(*leaf)
            new_p.append(_placed_as(placed[3], p_new))
            new_m.append(_placed_as(placed[1], m_new))
            new_v.append(_placed_as(placed[2], v_new))
            continue
        p = leaf[3]
        rows = (max(1, DONATE_SLICE_ELEMENTS * p.shape[0] // p.numel())
                if p.dim() and p.numel() else 1)
        for g, m, v, p in zip(*(t.split(rows) if t.dim() else (t,)
                                for t in leaf)):
            p_new, m_new, v_new = update(g, m, v, p)
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
    count = _placed_as(state["count"], count)
    if donate:
        state["count"] = count
        return params, state, {"grad_norm": gnorm}
    return (_like(params, new_p),
            {"mu": _like(params, new_m), "nu": _like(params, new_v),
             "count": count},
            {"grad_norm": gnorm})
