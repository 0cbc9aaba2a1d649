"""Three-term roofline of a dry-run cell — counterpart of
``repro.launch.roofline``.

    compute    = per-device flops / the card's bf16 peak
    memory     = per-device bytes accessed / the card's HBM bandwidth
    collective = per-device collective bytes / the bandwidth between cards

The per-device numbers are :mod:`repro_torch.launch.cost_analysis`'s
counts of one rank's step (the reference reads XLA's per-device
``cost_analysis()`` and its HLO's collectives), and the constants are the
H100's (:mod:`repro_torch.launch.mesh`).  ``model_flops`` is the
reference's 6*N*D (train) / 2*N*tokens (prefill) / 2*N*B (decode)
convention with N the active parameters of an MoE; :func:`param_count`
counts embedding and head apart and no norms but the layers' two.  The
row (:meth:`Roofline.row`) keeps the reference's field names, so the two
dry-runs' JSON rows line up.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch import mesh as _mesh
from repro_torch.models.common import Config


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    per_device_flops: float
    per_device_bytes: float
    collective_bytes: float          # per device
    collective_detail: Dict[str, int]
    collective_counts: Dict[str, int]
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0        # MODEL_FLOPS / (flops x chips)
    step_s: float = 0.0              # max of the three terms
    roofline_frac: float = 0.0       # ideal compute time / step_s
    arg_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0

    def finish(self):
        """The three terms, the bottleneck, ``useful_ratio`` and
        ``roofline_frac``, from the module's constants (read at call
        time)."""
        peak, hbm, link = (_mesh.PEAK_FLOPS_BF16, _mesh.HBM_BW,
                           _mesh.LINK_BW)
        self.compute_s = self.per_device_flops / peak
        self.memory_s = self.per_device_bytes / hbm
        self.collective_s = self.collective_bytes / link
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        self.step_s = max(terms.values())
        if self.model_flops and self.per_device_flops:
            self.useful_ratio = self.model_flops / (self.per_device_flops *
                                                    self.chips)
        ideal = self.model_flops / (peak * self.chips) \
            if self.model_flops else self.compute_s
        self.roofline_frac = ideal / self.step_s if self.step_s else 0.0
        return self

    def row(self) -> Dict:
        return dataclasses.asdict(self)


def param_count(cfg: Config, active_only: bool = False) -> float:
    """Parameter count from the config (dense or active-expert subset)."""
    d, v = cfg.d_model, cfg.vocab
    n = v * d * 2  # embed + head
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head \
        + cfg.n_heads * cfg.d_head * d
    if cfg.family in ("dense", "moe", "vlm"):
        mlp = 3 * d * cfg.d_ff if cfg.d_ff else 0
        moe = 0.0
        if cfg.family == "moe":
            e = cfg.top_k if active_only else cfg.n_experts
            moe = e * 3 * d * cfg.d_expert_ff + d * cfg.n_experts
        n += cfg.n_layers * (attn + mlp + moe + 2 * d)
    elif cfg.family == "ssm":
        n += cfg.n_layers * _ssm_params(cfg)
    elif cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.hybrid_group
        mamba_layers = n_groups * (cfg.hybrid_group - 1)
        # the shared attention block counted once
        n += mamba_layers * _ssm_params(cfg) + attn + 3 * d * cfg.d_ff
    elif cfg.family == "encdec":
        mlp = 3 * d * cfg.d_ff
        n += cfg.n_enc_layers * (attn + mlp) + cfg.n_layers * (2 * attn + mlp)
    return float(n)


def _ssm_params(cfg: Config) -> float:
    d, din = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return (2 * d * din + 2 * d * gn + d * cfg.ssm_heads + din * d +
            cfg.conv_width * (din + 2 * gn))


def model_flops(cfg: Config, shape_kind: str, seq: int, gbatch: int) -> float:
    """6*N*D for training, 2*N*tokens for prefill, 2*N*B for decode (one
    token a sequence); N the active parameters."""
    n_active = param_count(cfg, active_only=True)
    tokens = seq * gbatch
    if shape_kind == "train":
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * gbatch


def build_roofline(arch: str, shape: str, mesh_name: str, chips: int,
                   cost, cfg: Config, kind: str, seq: int,
                   gbatch: int) -> Roofline:
    """The cell's :class:`Roofline` from ``cost``, a
    :class:`repro_torch.launch.cost_analysis.Cost` of one rank's step (the
    reference takes ``cost_analysis()``, the HLO text and
    ``memory_analysis()``)."""
    total, detail, counts = cost.collectives()
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        per_device_flops=float(cost.flops),
        per_device_bytes=float(cost.bytes_accessed),
        collective_bytes=float(total),
        collective_detail=detail,
        collective_counts=counts,
        model_flops=model_flops(cfg, kind, seq, gbatch),
        arg_bytes_per_device=float(cost.arg_bytes),
        temp_bytes_per_device=float(cost.temp_bytes),
    )
    return r.finish()
