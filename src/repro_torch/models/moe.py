"""Top-k mixture of experts with a fixed capacity per expert.

Counterpart of ``repro.models.moe``.  Without a mesh every expert is local,
which is what the reference runs on a 1x1 mesh; the two weight layouts of
``cfg.moe_impl`` (``fsdp_gather``, ``expert_tp``) differ only in how the
reference shards the expert weights, so both compute the same thing there.

On a mesh (the operands are ``DTensor``s) the ``fsdp_gather`` layout runs
as the reference's ``shard_map`` region, a ``local_map`` over the same
specs: tokens are batch-sharded over (pod, data) and replicated over
``model``; each model rank holds E / model experts, routes its tokens to
them into buffers whose capacity comes from its *local* token count, and
the partial outputs are summed over ``model``.  The router and the expert
weights, FSDP-sharded over ``data`` on their embed axis, are all-gathered
over ``data`` on entry (the redistribute at the region's boundary; its
backward reduce-scatters their gradients).

``expert_tp`` is the reference's inference layout: with a ``data`` axis
that divides the model width and the expert FFN width, the experts' FFN
axis is split over ``data`` (and the experts over ``model``), the tokens
and the router are gathered over ``data``, each rank runs its experts'
FFN slice on every gathered token (capacity from the gathered count), and
the partial outputs are summed over ``model`` and ``data``, each rank
keeping its own batch rows (one reduce-scatter).  The stored layout is
the same for both (embed split over ``data``, as the reference's
``moe_specs``), so the region's boundary moves each expert weight from
its embed split to its FFN split (an all-to-all over ``data``), as the
reference's ``shard_map`` boundary does.  Without such a ``data`` axis
``expert_tp`` runs as ``fsdp_gather``, as in the reference.

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import (Config, P_, local_call, mesh_sizes,
                                      resolve_spec)

MOE_IMPLS = ("fsdp_gather", "expert_tp")


def moe_specs(cfg: Config, n_layers: int) -> Dict[str, P_]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert_ff
    L = (n_layers,)
    return {
        "router": P_(L + (d, e), ("layers", "embed", "expert")),
        "wg": P_(L + (e, d, f), ("layers", "expert", "embed", "expert_mlp")),
        "wu": P_(L + (e, d, f), ("layers", "expert", "embed", "expert_mlp")),
        "wd": P_(L + (e, f, d), ("layers", "expert", "expert_mlp", "embed")),
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


def _moe_local(x, router, wg, wu, wd, cfg: Config, e0: int = 0,
               e_loc: int = None) -> torch.Tensor:
    """The experts ``e0 .. e0 + e_loc`` (all of them by default) on the
    tokens x (B, S, D): each token's sum of its kept assignments to those
    experts, weighted by its routing weights.  ``wg``/``wu``/``wd`` hold
    those experts' weights; the capacity comes from x's token count."""
    bsz, s, d = x.shape
    t, k = bsz * s, cfg.top_k
    e_loc = cfg.n_experts if e_loc is None else e_loc
    capacity = _capacity(t, cfg)
    xf = x.reshape(t, d)
    r = _route(xf, router, cfg, capacity)
    # an assignment's slot in its expert's buffer does not depend on the
    # other experts, so the kept local ones are the global route's
    keep = r.keep & (r.slot_e >= e0) & (r.slot_e < e0 + e_loc)
    slot_e = torch.where(keep, r.slot_e - e0, e_loc)
    slot_c = torch.where(keep, r.slot_c, 0)
    tok = torch.arange(t * k, device=x.device) // k

    buf = torch.zeros((e_loc + 1, capacity, d), dtype=x.dtype,
                      device=x.device)
    buf[slot_e, slot_c] = xf[tok]
    act = buf[:e_loc]
    g = torch.bmm(act, wg.to(x.dtype))
    u = torch.bmm(act, wu.to(x.dtype))
    y_buf = torch.bmm(F.silu(g) * u, wd.to(x.dtype))
    y_buf = torch.cat([y_buf, y_buf.new_zeros((1, capacity, d))])

    vals = y_buf[slot_e, slot_c] * keep[:, None]
    vals = vals * r.weights.reshape(-1)[:, None].to(vals.dtype)
    # each token's k assignments are consecutive: the scatter-add over
    # tokens is a sum over k
    y = vals.reshape(t, k, d).sum(dim=1)
    if cfg.moe_psum_dtype == "bf16":
        y = y.to(torch.bfloat16)
    return y.reshape(bsz, s, d)


def moe_apply(x: torch.Tensor, p, cfg: Config) -> torch.Tensor:
    """x: (B, S, D); p holds this layer's ``router``, ``wg``, ``wu``,
    ``wd``.  The expert weights are cast to x's dtype.  On a mesh (x a
    ``DTensor``) see the module docstring."""
    if cfg.moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {cfg.moe_impl!r}: expected one of "
                         f"{MOE_IMPLS}")
    if isinstance(x, DTensor):
        return _moe_sharded(x, p, cfg)
    return _moe_local(x, p["router"], p["wg"], p["wu"], p["wd"],
                      cfg).to(x.dtype)


def _expert_tp(cfg: Config, mesh) -> bool:
    """Whether ``expert_tp`` splits the expert FFN over ``data`` on
    ``mesh`` (the reference's condition)."""
    data = mesh_sizes(mesh).get("data", 1)
    return (cfg.moe_impl == "expert_tp" and data > 1
            and cfg.d_model % data == 0 and cfg.d_expert_ff % data == 0)


def _moe_sharded(x, p, cfg: Config):
    """The reference's ``shard_map`` MoE on x's mesh: x batch-sharded over
    (pod, data) where its batch divides, replicated over model; the router
    whole; the experts split over model (where their number divides) and,
    under ``expert_tp``, their FFN axis over data with the tokens gathered
    over data.  The outputs are partial over model (and data), and the
    gradients of x, the router and the experts partial where
    ``common.local_call`` makes them so."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    model = mesh_sizes(mesh).get("model", 1)
    has_model = model > 1 and cfg.n_experts % model == 0
    e_loc = cfg.n_experts // model if has_model else cfg.n_experts
    e0 = mesh.get_local_rank("model") * e_loc if has_model else 0
    split = names.index("model") if has_model else None
    tp = names.index("data") if _expert_tp(cfg, mesh) else None
    x_in = resolve_spec(x.shape, ("batch", None, None), mesh)
    whole = (Replicate(),) * mesh.ndim

    def experts(ffn):
        """The expert weights' placements: experts over model, the FFN
        axis ``ffn`` over data under expert_tp."""
        return tuple(Shard(0) if i == split else
                     Shard(ffn) if i == tp else Replicate()
                     for i in range(mesh.ndim))

    tokens = x_in if tp is None else tuple(
        Replicate() if i == tp else pl for i, pl in enumerate(x_in))
    out = [Partial() if i in (split, tp) else pl
           for i, pl in enumerate(tokens)]

    def local(x, router, wg, wu, wd):
        return _moe_local(x, router, wg, wu, wd, cfg, e0, e_loc)

    y = local_call(local, (x.redistribute(mesh, tokens),
                           p["router"].redistribute(mesh, whole),
                           p["wg"].redistribute(mesh, experts(2)),
                           p["wu"].redistribute(mesh, experts(2)),
                           p["wd"].redistribute(mesh, experts(1))), out)
    # the sum over model (and data), in bf16 under moe_psum_dtype "bf16"
    return y.redistribute(mesh, x_in).to(x.dtype)
