"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro.optim.adamw``.  Parameters, gradients and moments are
a tensor, or a list or a dict of tensors (one level; the reference takes any
pytree).
The update computes in each *moment*'s dtype: float32 moments by default,
``moment_dtype=torch.float64`` in :func:`adamw_init` for full-precision
optimization (the adam optimizer of
:mod:`repro_torch.core.vqe` runs it in float64).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def _like(tree, leaves):
    if isinstance(tree, torch.Tensor):
        return leaves[0]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), leaves))
    return list(leaves)


def adamw_init(params, moment_dtype=torch.float32) -> Dict[str, Any]:
    def zeros():
        return _like(params, [torch.zeros(p.shape, dtype=moment_dtype,
                                          device=p.device)
                              for p in _leaves(params)])
    first = _leaves(params)[0]
    return {"mu": zeros(), "nu": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each promoted to at least
    float32 (never truncated: float64 gradients keep a float64 norm)."""
    sq = [torch.sum(torch.square(
        x.to(torch.promote_types(x.dtype, torch.float32))))
        for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_update(grads, state, params, cfg: OptConfig, lr=None):
    """Returns ``(new_params, new_state, metrics)``; the update computes in
    each moment leaf's dtype."""
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1

    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(_leaves(grads), _leaves(state["mu"]),
                          _leaves(state["nu"]), _leaves(params)):
        dt = m.dtype
        c1 = 1.0 - torch.pow(cfg.b1, count.to(dt))
        c2 = 1.0 - torch.pow(cfg.b2, count.to(dt))
        gd = g.to(dt) * scale.to(dt)
        m_new = cfg.b1 * m + (1 - cfg.b1) * gd
        v_new = cfg.b2 * v + (1 - cfg.b2) * gd * gd
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        pd = p.to(dt)
        p_new = pd - lr * (step + cfg.weight_decay * pd)
        new_p.append(p_new.to(p.dtype))
        new_m.append(m_new)
        new_v.append(v_new)
    return (_like(params, new_p),
            {"mu": _like(params, new_m), "nu": _like(params, new_v),
             "count": count},
            {"grad_norm": gnorm})
