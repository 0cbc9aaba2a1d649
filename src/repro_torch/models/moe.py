"""Top-k mixture of experts with a fixed capacity per expert.

Counterpart of ``repro.models.moe`` on one card: its per-shard
``_moe_local`` with every expert local, no model axis and no FSDP axes,
which is what the reference runs on a 1x1 mesh.  The two weight layouts of
``cfg.moe_impl`` (``fsdp_gather``, ``expert_tp``) differ only in how the
reference shards the expert weights, so both compute the same thing here.

Routing (:func:`_route`): router logits in f32, softmax, top-k (weights
renormalized under ``norm_topk``), then each (token, k) assignment, in the
flattened (token, k) order, takes the next free slot of its expert's
buffer; an assignment whose expert already holds ``capacity`` tokens is
dropped.  The kept tokens go into an (E + 1, C, D) buffer whose last row
collects the dropped ones, the experts run as three batched GEMMs, and each
token sums its kept experts' outputs by its routing weights.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Config, P_

MOE_IMPLS = ("fsdp_gather", "expert_tp")


def moe_specs(cfg: Config, n_layers: int) -> Dict[str, P_]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert_ff
    L = (n_layers,)
    return {
        "router": P_(L + (d, e)),
        "wg": P_(L + (e, d, f)),
        "wu": P_(L + (e, d, f)),
        "wd": P_(L + (e, f, d)),
    }


def _capacity(n_tokens: int, cfg: Config) -> int:
    """Slots per expert: ceil(T k capacity_factor / E), at least k."""
    per_expert = (n_tokens * cfg.top_k * cfg.capacity_factor) / cfg.n_experts
    return max(cfg.top_k, int(-(-per_expert // 1)))


class Route(NamedTuple):
    """Where each of the T * k assignments goes, in (token, k) order."""
    weights: torch.Tensor     # (T, k) routing weights, f32
    slot_e: torch.Tensor      # (T * k,) expert; E (the dump row) if dropped
    slot_c: torch.Tensor      # (T * k,) slot in that buffer; 0 if dropped
    keep: torch.Tensor        # (T * k,) bool: the assignment has a slot


def _route(xf: torch.Tensor, router: torch.Tensor, cfg: Config,
           capacity: int) -> Route:
    """Route the tokens xf (T, D) with ``router`` (D, E)."""
    e = cfg.n_experts
    logits = xf.float() @ router.float()
    weights, idx = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k)
    if cfg.norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    flat = idx.reshape(-1)
    # the exclusive prefix count of each assignment's expert, over an
    # (E, T * k) one-hot: a comparison (F.one_hot's range check waits for
    # the card), scanned along its inner axis (on the H100 a scan along the
    # outer axis of a (T * k, E) one-hot took most of a prefill's time)
    onehot = (torch.arange(e, device=flat.device)[:, None] == flat).int()
    rank = (torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
            ).gather(0, flat[None])[0]
    keep = rank < capacity
    return Route(weights, torch.where(keep, flat, e),
                 torch.where(keep, rank, 0), keep)


def moe_apply(x: torch.Tensor, p, cfg: Config) -> torch.Tensor:
    """x: (B, S, D); p holds this layer's ``router``, ``wg``, ``wu``,
    ``wd``.  The expert weights are cast to x's dtype."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {cfg.moe_impl!r}: expected one of "
                         f"{MOE_IMPLS}")
    bsz, s, d = x.shape
    t, k, e = bsz * s, cfg.top_k, cfg.n_experts
    capacity = _capacity(t, cfg)
    xf = x.reshape(t, d)
    r = _route(xf, p["router"], cfg, capacity)
    tok = torch.arange(t * k, device=x.device) // k

    buf = torch.zeros((e + 1, capacity, d), dtype=x.dtype, device=x.device)
    buf[r.slot_e, r.slot_c] = xf[tok]
    act = buf[:e]
    g = torch.bmm(act, p["wg"].to(x.dtype))
    u = torch.bmm(act, p["wu"].to(x.dtype))
    y_buf = torch.bmm(F.silu(g) * u, p["wd"].to(x.dtype))
    y_buf = torch.cat([y_buf, y_buf.new_zeros((1, capacity, d))])

    vals = y_buf[r.slot_e, r.slot_c] * r.keep[:, None]
    vals = vals * r.weights.reshape(-1)[:, None].to(vals.dtype)
    # each token's k assignments are consecutive: the scatter-add over
    # tokens is a sum over k
    y = vals.reshape(t, k, d).sum(dim=1)
    if cfg.moe_psum_dtype == "bf16":
        y = y.to(torch.bfloat16)
    return y.reshape(bsz, s, d).to(x.dtype)
