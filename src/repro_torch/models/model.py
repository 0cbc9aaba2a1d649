"""build(cfg, opt_cfg) -> ModelBundle: specs, init, the loss and train
step, prefill and serve steps.

Counterpart of ``repro.models.model`` on one card: no mesh and no
shardings.  The bundle is the same for every family: ``transformer`` picks
the stack, loss, cache and decode of the decoder-only ones (dense, moe,
vlm, ssm, hybrid), ``encdec`` those of the encoder-decoder.  Parameters
are plain nested dicts of tensors that do not require grad:
:meth:`ModelBundle.train_step` takes the gradient with
``torch.autograd.grad`` over detached leaves and returns new parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import Config, init_params, tree_leaves
from repro_torch.optim.adamw import OptConfig, adamw_init, adamw_update


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


@dataclasses.dataclass
class ModelBundle:
    cfg: Config
    specs: Any
    opt_cfg: OptConfig = dataclasses.field(default_factory=OptConfig)

    def init(self, seed: int, device=None) -> Any:
        """Parameters drawn on ``device`` from a ``torch.Generator`` seeded
        with ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.specs, gen, self.cfg.param_dtype, device)

    def abstract_params(self) -> Any:
        """The parameter tree as ``meta`` tensors: shapes and dtypes, with
        nothing allocated."""
        return _with_leaves(self.specs, [
            torch.empty(s.shape, dtype=s.dtype or self.cfg.param_dtype,
                        device="meta") for _, s in tree_leaves(self.specs)])

    def abstract_opt_state(self) -> Any:
        """AdamW's state for :meth:`abstract_params`, as ``meta`` tensors."""
        return adamw_init(self.abstract_params())

    # ----------------------------------------------------------------- steps
    def loss_fn(self, params, batch) -> torch.Tensor:
        if self._encdec:
            return encdec_mod.loss_fn(params, self.cfg, batch)
        return tf_mod.loss_fn(params, self.cfg, batch)

    def value_and_grad(self, params, batch):
        """(loss, gradient tree): ``torch.autograd.grad`` of
        :meth:`loss_fn` over detached copies of the parameter leaves."""
        leaves = [t.detach().requires_grad_() for _, t in tree_leaves(params)]
        with torch.enable_grad():
            loss = self.loss_fn(_with_leaves(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
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

    def init_cache(self, batch: int, max_seq: int, device=None):
        return self._mod.init_cache(self.cfg, batch, max_seq, device=device)

    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    @property
    def _mod(self):
        return encdec_mod if self._encdec else tf_mod


def build(cfg: Config, opt_cfg: OptConfig = None) -> ModelBundle:
    specs = (encdec_mod.encdec_specs(cfg) if cfg.family == "encdec"
             else tf_mod.lm_specs(cfg))
    return ModelBundle(cfg=cfg, specs=specs, opt_cfg=opt_cfg or OptConfig())
