"""build(cfg) -> ModelBundle: specs, init, prefill and serve steps.

Counterpart of ``repro.models.model`` for serving on one card: no mesh, no
shardings and no ``train_step`` (LM training is a later slice of the port,
``ROADMAP.md`` §1).  The bundle is the same for every family:
``transformer`` picks the stack, cache and decode of the decoder-only ones
(dense, moe, vlm, ssm, hybrid), ``encdec`` serves the encoder-decoder.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import Config, init_params


@dataclasses.dataclass
class ModelBundle:
    cfg: Config
    specs: Any

    def init(self, seed: int, device=None) -> Any:
        """Parameters drawn on ``device`` from a ``torch.Generator`` seeded
        with ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.specs, gen, self.cfg.param_dtype, device)

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


def build(cfg: Config) -> ModelBundle:
    specs = (encdec_mod.encdec_specs(cfg) if cfg.family == "encdec"
             else tf_mod.lm_specs(cfg))
    return ModelBundle(cfg=cfg, specs=specs)
