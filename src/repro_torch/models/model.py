"""build(cfg, opt_cfg, mesh) -> ModelBundle: specs, init, shardings, the
loss and train steps, prefill and serve steps.

Counterpart of ``repro.models.model``.  The bundle is the same for every
family: ``transformer`` picks the stack, loss, cache and decode of the
decoder-only ones (dense, moe, vlm, ssm, hybrid), ``encdec`` those of the
encoder-decoder.  Parameters are plain nested dicts of tensors that do not
require grad: :meth:`ModelBundle.train_step` takes the gradient with
``torch.autograd.grad`` over detached leaves and returns new parameters.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh`` with axes
``data``, ``model`` and optionally ``pod``; one process per device) the
parameters, moments and batch are ``DTensor``s placed by the reference's
rules (:meth:`ModelBundle.param_shardings`, :meth:`opt_shardings`,
:meth:`batch_sharding`; :meth:`shard` puts full parameters there), and the
same ``train_step`` runs the SPMD program: every op on its shards, the
collectives where the placements ask for them.  Without a mesh nothing is
a ``DTensor`` and the step is the one-device step, bit for bit.

Serving on a mesh: :meth:`ModelBundle.init` draws each rank's shard of
the parameters alone (``common.init_params`` with shardings), the decode
cache is placed by :meth:`ModelBundle.cache_shardings` (the reference's
rules and fallbacks), and ``prefill_step``, ``encode_step`` and
``serve_step`` take and return ``DTensor`` parameters and caches.

:data:`SHAPES` are the reference's input shapes and
:meth:`ModelBundle.input_specs` their stand-ins (``meta`` tensors) and
placements, which the dry-run (:mod:`repro_torch.launch.dryrun`) runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import (Config, NamedSharding, batch_axes,
                                      cache_shardings, distribute,
                                      init_params, mesh_device, mesh_sizes,
                                      param_shardings, replicating,
                                      tree_leaves)
from repro_torch.optim.adamw import OptConfig, adamw_init, adamw_update


# The reference's input shapes: (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
    # reduced variants for smoke tests
    "smoke_train": (64, 2, "train"),
    "smoke_prefill": (64, 2, "prefill"),
    "smoke_decode": (64, 2, "decode"),
}


def _with_leaves(tree, leaves: List[torch.Tensor]):
    """``tree`` (nested dicts) with its leaves, in ``tree_leaves`` order,
    replaced by ``leaves``."""
    out: Dict[str, Any] = {}
    for (path, _), leaf in zip(tree_leaves(tree), leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def split_batch(batch, microbatches: int):
    """``batch`` cut into ``microbatches`` along its batch axis: axis 0,
    or axis 1 of the vlm's (3, B, S) ``positions``."""
    parts = [dict() for _ in range(microbatches)]
    for k, v in batch.items():
        axis = 1 if k == "positions" and v.dim() == 3 else 0
        if v.shape[axis] % microbatches:
            raise ValueError(f"{k}: a batch of {v.shape[axis]} does not split "
                             f"into {microbatches} microbatches")
        for part, piece in zip(parts, v.chunk(microbatches, dim=axis)):
            part[k] = piece
    return parts


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclasses.dataclass
class ModelBundle:
    cfg: Config
    specs: Any
    opt_cfg: OptConfig = dataclasses.field(default_factory=OptConfig)
    mesh: Any = None              # a DeviceMesh, or None for one device

    def init(self, seed: int, device=None) -> Any:
        """Parameters drawn on ``device`` from a ``torch.Generator`` seeded
        with ``seed``.  On a mesh, on this rank's device, each leaf a
        ``DTensor`` of this rank's shard alone, bit for bit
        ``distribute(init(seed), param_shardings())`` of the one-device
        draw (each rank draws the whole stream and keeps its part)."""
        if self.mesh is None:
            device = resolve_device(device)
            shardings = None
        else:
            device = mesh_device(self.mesh)
            shardings = self.param_shardings()
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.specs, gen, self.cfg.param_dtype, device,
                           shardings)

    def abstract_params(self) -> Any:
        """The parameter tree as ``meta`` tensors: shapes and dtypes, with
        nothing allocated."""
        return _with_leaves(self.specs, [
            torch.empty(s.shape, dtype=s.dtype or self.cfg.param_dtype,
                        device="meta") for _, s in tree_leaves(self.specs)])

    def abstract_opt_state(self) -> Any:
        """AdamW's state for :meth:`abstract_params`, as ``meta`` tensors."""
        return adamw_init(self.abstract_params())

    # ------------------------------------------------------------- shardings
    def _need_mesh(self):
        if self.mesh is None:
            raise ValueError("this bundle has no mesh: build(cfg, mesh=...)")
        return self.mesh

    def param_shardings(self) -> Any:
        """A :class:`NamedSharding` per parameter, by the reference's
        rules."""
        return param_shardings(self.specs, self._need_mesh())

    def opt_shardings(self) -> Any:
        """AdamW's moments placed as their parameters, the count
        replicated."""
        ps = self.param_shardings()
        mesh = self._need_mesh()
        return {"mu": ps, "nu": ps,
                "count": NamedSharding(mesh, (Replicate(),) * mesh.ndim)}

    def batch_sharding(self, batch_size: Optional[int] = None
                       ) -> NamedSharding:
        """The placements of a (B, S) batch: B split over (pod, data); a
        ``batch_size`` that does not divide falls back to the pods alone,
        then to replicated (the reference's fallback)."""
        mesh = self._need_mesh()
        sizes, names = mesh_sizes(mesh), mesh.mesh_dim_names
        axes = batch_axes(mesh)
        if batch_size is not None:
            n = 1
            for a in axes:
                n *= sizes[a]
            if batch_size % n:
                axes = tuple(a for a in axes
                             if a == "pod" and batch_size % sizes[a] == 0)
        return NamedSharding(mesh, tuple(
            Shard(0) if a in axes else Replicate() for a in names))

    def shard(self, params):
        """A full parameter tree onto the mesh by :meth:`param_shardings`
        (see ``common.distribute``; an AdamW state goes by
        ``distribute(state, bundle.opt_shardings())``).  :meth:`init` on a
        mesh draws the parameters placed already."""
        return distribute(params, self.param_shardings())

    def shard_batch(self, batch):
        """A full batch onto the mesh: ``tokens``, ``labels`` and the
        encdec's ``frames`` split on their batch axis by
        :meth:`batch_sharding`, the vlm's (3, B, S) ``positions`` on its
        axis 1."""
        bs = self.batch_sharding(batch["tokens"].shape[0])
        out = {}
        for k, v in batch.items():
            placements = bs.placements
            if k == "positions" and v.dim() == 3:
                placements = tuple(Shard(1) if p.is_shard() else p
                                   for p in placements)
            out[k] = distribute(v, NamedSharding(bs.mesh, placements))
        return out

    # ----------------------------------------------------------------- steps
    def loss_fn(self, params, batch) -> torch.Tensor:
        if self._encdec:
            return encdec_mod.loss_fn(params, self.cfg, batch)
        return tf_mod.loss_fn(params, self.cfg, batch)

    def value_and_grad(self, params, batch):
        """(loss, gradient tree): ``torch.autograd.grad`` of
        :meth:`loss_fn` over detached copies of the parameter leaves.  On a
        mesh the loss comes back whole on every rank and each gradient
        placed as its parameter; plain tensors that the models make (the
        default positions, RoPE's frequencies) count as replicated."""
        pairs = tree_leaves(params)
        leaves = [t.detach().requires_grad_() for _, t in pairs]
        with torch.enable_grad(), replicating(leaves[0]):
            loss = self.loss_fn(_with_leaves(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if g.placements != p.placements else g
                     for g, (_, p) in zip(grads, pairs)]
        return loss.detach(), _with_leaves(params, list(grads))

    def train_step(self, params, opt_state, batch, microbatches: int = 1,
                   donate: bool = False):
        """One AdamW step: (new params, new opt state, metrics with
        ``loss`` and ``grad_norm``).  With ``microbatches > 1`` the batch is
        split (:func:`split_batch`), the gradients accumulate in f32 and
        the loss is the mean, as the reference's scan does.  ``donate``
        writes the new parameters and moments into the old tensors (see
        :func:`~repro_torch.optim.adamw.adamw_update`)."""
        if microbatches == 1:
            loss, grads = self.value_and_grad(params, batch)
        else:
            loss, acc = 0.0, None
            for micro in split_batch(batch, microbatches):
                part, g = self.value_and_grad(params, micro)
                g = [t.float() for _, t in tree_leaves(g)]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                loss = loss + part
            loss = loss / microbatches
            grads = _with_leaves(params, [a / microbatches for a in acc])
        new_params, new_opt, metrics = adamw_update(
            grads, opt_state, params, self.opt_cfg, donate=donate)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    def train_step_compressed(self, params, opt_state, err_state, batch):
        """A train step whose cross-pod gradient all-reduce carries int8
        with error feedback (a mesh with a ``pod`` axis): the reference's
        ``shard_map`` manual over ``pod`` alone.  Each pod takes the
        gradient of its batch shard with ``data`` and ``model`` still
        ``DTensor`` axes, every leaf is averaged over the pods by
        :func:`~repro_torch.optim.compression.psum_compressed`, the loss is
        averaged over the pods, then AdamW.  Returns (params, opt state,
        error state, metrics)."""
        from repro_torch.optim.compression import psum_compressed
        mesh = self._need_mesh()
        names = mesh.mesh_dim_names
        if "pod" not in names:
            raise ValueError("train_step_compressed needs a mesh with a "
                             "'pod' axis")
        pod = names.index("pod")
        sub = mesh[tuple(n for n in names if n != "pod")]
        group = mesh.get_group("pod")

        def per_pod(t):
            """The pod's own shard of t, placed on the other axes."""
            rest = t.placements[:pod] + t.placements[pod + 1:]
            return DTensor.from_local(t.to_local(), sub, rest)

        def whole(t, like):
            """A per-pod result (the same in every pod) placed as ``like``
            on the whole mesh."""
            return DTensor.from_local(t.to_local(), mesh, like.placements,
                                      shape=like.shape, stride=like.stride())

        p_pod = _tree_map(per_pod, params)
        loss, grads = self.value_and_grad(p_pod, _tree_map(per_pod, batch))
        pairs = [psum_compressed(g, e, group) for g, e in zip(
            [g for _, g in tree_leaves(grads)],
            [per_pod(e) for _, e in tree_leaves(err_state)])]
        grads = _with_leaves(params, [g for g, _ in pairs])
        err = _with_leaves(params, [e for _, e in pairs])
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
        new_params, new_opt, metrics = adamw_update(
            grads, _tree_map(per_pod, opt_state), p_pod, self.opt_cfg)
        metrics["loss"] = loss
        return (_tree_map(whole, new_params, params),
                _tree_map(whole, new_opt, opt_state),
                _tree_map(whole, err, err_state), metrics)

    def prefill_step(self, params, tokens):
        """Prefill with the cache sized to the prompt, as the reference does:
        a following ``serve_step`` finds the cache full and raises.  Call
        ``transformer.prefill`` with a larger ``max_seq`` to decode on."""
        if self._encdec:
            raise ValueError("prefill_step: the encdec family has no prefill; "
                             "use encode_step for the encoder")
        return tf_mod.prefill(params, self.cfg, tokens, tokens.shape[1])

    def encode_step(self, params, frames):
        return encdec_mod.encode(params, self.cfg, frames)

    def serve_step(self, params, cache, token, positions=None):
        return self._mod.decode_step(params, self.cfg, cache, token, positions)

    def cache_specs(self, batch: int, max_seq: int):
        return self._mod.init_cache_specs(self.cfg, batch, max_seq)

    def cache_shardings(self, batch: int, max_seq: int):
        """A :class:`NamedSharding` per cache entry (``index`` replicated),
        by the reference's rules with its kv_seq and batch fallbacks
        (``common.cache_shardings``)."""
        return cache_shardings(self.cache_specs(batch, max_seq),
                               self._mod.cache_logical_axes(self.cfg),
                               self._need_mesh())

    def input_specs(self, shape_name: str, seq: Optional[int] = None,
                    batch: Optional[int] = None) -> Dict[str, Any]:
        """Stand-ins (``meta`` tensors, nothing allocated) and placements
        (:class:`NamedSharding`) of the inputs of one of :data:`SHAPES`,
        under the reference's keys: ``kind``; train: ``batch`` and
        ``batch_shardings`` (``tokens``, ``labels``, the vlm's (3, B, S)
        ``positions`` split on axis 1, the encdec's ``frames`` on axis 0);
        prefill: ``tokens`` and ``tokens_sharding``, or the encdec's
        ``frames`` and ``frames_sharding``; decode: ``cache`` and
        ``cache_shardings`` (``index`` a scalar int32, as the reference's),
        ``token`` and ``token_sharding``, the vlm's (3, B, 1)
        ``positions`` (no placement: the reference gives it none).  The
        batch placement falls back as :meth:`batch_sharding` does
        (``long_500k``'s batch of 1 is whole).  ``seq`` and ``batch``
        replace the shape's own (a cell cut to size)."""
        s0, b0, kind = SHAPES[shape_name]
        seq, gbatch = seq or s0, batch or b0
        cfg = self.cfg

        def stand_in(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        bspec = self.batch_sharding(gbatch)
        mesh = bspec.mesh

        def on_axis(axis):
            return NamedSharding(mesh, tuple(
                Shard(axis) if p.is_shard() else p for p in bspec.placements))

        out: Dict[str, Any] = {"kind": kind}
        if kind == "train":
            out["batch"] = {"tokens": stand_in((gbatch, seq)),
                            "labels": stand_in((gbatch, seq))}
            out["batch_shardings"] = {"tokens": bspec, "labels": bspec}
            if cfg.family == "encdec":
                out["batch"]["frames"] = stand_in(
                    (gbatch, cfg.enc_frames, cfg.d_model), torch.float32)
                out["batch_shardings"]["frames"] = on_axis(0)
            elif cfg.family == "vlm":
                out["batch"]["positions"] = stand_in((3, gbatch, seq))
                out["batch_shardings"]["positions"] = on_axis(1)
        elif kind == "prefill":
            if cfg.family == "encdec":
                out["frames"] = stand_in((gbatch, seq, cfg.d_model),
                                         torch.float32)
                out["frames_sharding"] = on_axis(0)
            else:
                out["tokens"] = stand_in((gbatch, seq))
                out["tokens_sharding"] = bspec
        else:
            out["cache"] = {name: stand_in(spec.shape, spec.dtype)
                            for name, spec in self.cache_specs(
                                gbatch, seq).items()}
            out["cache_shardings"] = self.cache_shardings(gbatch, seq)
            out["token"] = stand_in((gbatch, 1))
            out["token_sharding"] = bspec
            if cfg.family == "vlm":
                out["positions"] = stand_in((3, gbatch, 1))
        return out

    def init_cache(self, batch: int, max_seq: int, device=None):
        """A zero cache: on one device, or on the mesh placed by
        :meth:`cache_shardings`."""
        return self._mod.init_cache(self.cfg, batch, max_seq, device=device,
                                    mesh=self.mesh)

    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    @property
    def _mod(self):
        return encdec_mod if self._encdec else tf_mod


def build(cfg: Config, opt_cfg: OptConfig = None, mesh=None) -> ModelBundle:
    """The bundle of ``cfg``: on one device, or on ``mesh`` (a
    ``DeviceMesh``; see the module docstring)."""
    specs = (encdec_mod.encdec_specs(cfg) if cfg.family == "encdec"
             else tf_mod.lm_specs(cfg))
    return ModelBundle(cfg=cfg, specs=specs, opt_cfg=opt_cfg or OptConfig(),
                       mesh=mesh)
