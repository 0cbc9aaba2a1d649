"""int8 error-feedback gradient compression for the cross-pod all-reduce.

Counterpart of ``repro.optim.compression``.  At two pods the cross-pod
gradient all-reduce is the only traffic on the slow links between pods;
compressing it shrinks that collective.  Scheme: a per-tensor scale
max|g| / 127, the gradient quantized to int8, the int8 payload summed over
the pods as int32, dequantized, and the quantization residual fed back
into the next step (error feedback, so the compression bias vanishes over
time).

:func:`psum_compressed` runs over a ``torch.distributed`` process group
(the ``pod`` axis of the mesh in
:meth:`~repro_torch.models.model.ModelBundle.train_step_compressed`); a
gradient that is a ``DTensor`` on the remaining axes is quantized on its
local shards with the scale of the whole tensor.  :func:`quantize`,
:func:`dequantize` and :func:`compress_residual` are the local steps.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.optim.adamw import _like, _leaves, _local, _placed_as


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, f32 scale) with scale = max(max|g|, 1e-12) / 127."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_residual(g: torch.Tensor, err: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression step: (q, scale, new_err) of g + err."""
    corrected = g.float() + err
    q, scale = quantize(corrected)
    return q, scale, corrected - dequantize(q, scale)


def psum_compressed(g: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of g over the ranks of ``group`` with an int8 payload and
    error feedback: (mean in g's dtype, new f32 residual).

    A MAX all-reduce of max|g + err| first agrees on one scale,
    pmax / 127 + 1e-12, so the summed int8 payload dequantizes exactly (up
    to its rounding, which the residual carries).  The payload crosses
    ``group`` as int32, one element per gradient element.  A ``DTensor``
    g (and err, placed as g) is quantized on its local shards: the max is
    taken over the whole tensor, then over ``group``."""
    corrected = _local(g).float() + _local(err)
    peak = torch.max(torch.abs(corrected))
    if isinstance(g, DTensor):
        for dim in range(g.device_mesh.ndim):
            dist.all_reduce(peak, dist.ReduceOp.MAX,
                            group=g.device_mesh.get_group(dim))
    dist.all_reduce(peak, dist.ReduceOp.MAX, group=group)
    scale = peak / 127.0 + 1e-12
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.float() * scale
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, dist.ReduceOp.SUM, group=group)
    mean = q_sum.float() * scale / dist.get_world_size(group)
    return _placed_as(g, mean.to(g.dtype)), _placed_as(err, new_err)


def init_error_state(params):
    """Zero f32 residuals beside every parameter (placed as it on a
    mesh)."""
    return _like(params, [torch.zeros_like(p, dtype=torch.float32)
                          if isinstance(p, DTensor)
                          else torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                          for p in _leaves(params)])
