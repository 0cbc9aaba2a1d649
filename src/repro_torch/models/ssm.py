"""Mamba2 (SSD) block: chunked scan for prefill, O(1)-state decode.

Counterpart of ``repro.models.ssm``.  The full-sequence block sends its
scan through :func:`repro_torch.kernels.ops.ssd` (the SSD kernel on the
card); :func:`ssd_chunked` is the plain chunked form in the reference's
(B, H, L, P) layout.  Both compute h_t = exp(a_t) h_{t-1} + B_t (x) x_t,
y_t = C_t . h_t.

On a mesh the decode state is a ``DTensor`` placed by the reference's
cache rules: ``ssm_h`` split over ``model`` by heads, ``ssm_conv`` split
evenly along its channels, which concatenate x, B and C and so do not line
up with the heads.  :func:`ssm_decode` makes the conv state and this
token's conv input whole at the boundary (a few KB a layer), runs the
recurrence on each rank's heads against its own block of ``ssm_h``, and
hands back the new conv state split as it was.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.common import (Config, P_, constrain, local_call,
                                      local_range, rms_norm, split_last,
                                      unshard)


def ssm_specs(cfg: Config, n_layers: int) -> Dict[str, P_]:
    d, din = cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = din + 2 * g * n
    L = (n_layers,)
    return {
        "wz": P_(L + (d, din), ("layers", "embed", "ssm_inner")),
        "wx": P_(L + (d, din), ("layers", "embed", "ssm_inner")),
        "wb": P_(L + (d, g * n), ("layers", "embed", "ssm_bc")),
        "wc": P_(L + (d, g * n), ("layers", "embed", "ssm_bc")),
        "wdt": P_(L + (d, h), ("layers", "embed", "ssm_heads")),
        "dt_bias": P_(L + (h,), ("layers", "ssm_heads"), init="zeros"),
        "a_log": P_(L + (h,), ("layers", "ssm_heads"), init="zeros"),
        "d_skip": P_(L + (h,), ("layers", "ssm_heads"), init="ones"),
        "conv_w": P_(L + (cfg.conv_width, conv_dim),
                     ("layers", "conv", "ssm_inner")),
        "norm": P_(L + (din,), ("layers", "ssm_inner"), init="ones"),
        "wo": P_(L + (din, d), ("layers", "ssm_inner", "embed")),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, L, C), w: (W, C) -> causal depthwise conv via shifted adds.
    Under a mesh it runs on each rank's batch shard (the shifts' ``pad``
    has no usable ``DTensor`` rule in every release), the sequence,
    channels and weights whole."""
    def conv(x, w):
        width = w.shape[0]
        out = x * w[-1]
        for i in range(1, width):
            shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
            out = out + shifted * w[width - 1 - i]
        return out

    x, w = unshard(x, 1, 2), unshard(w, 0, 1)
    return local_call(conv, (x, w), list(getattr(x, "placements", ())))


def ssd_chunked(x, b, c, a, chunk: int = 128, return_state: bool = False):
    """Plain chunked SSD in the reference's layout: x (B, H, L, P), b/c
    (B, H, L, N), a (B, H, L); the final state is (B, H, N, P) f32."""
    bsz, h, length, p = x.shape
    n = b.shape[-1]
    out = ssd_scan_plain(x.reshape(bsz * h, length, p),
                         b.reshape(bsz * h, length, n),
                         c.reshape(bsz * h, length, n),
                         a.reshape(bsz * h, length), chunk=chunk,
                         return_state=return_state)
    if return_state:
        y, state = out
        return y.reshape(bsz, h, length, p), state.reshape(bsz, h, n, p)
    return out.reshape(bsz, h, length, p)


def _split_proj(x, p, cfg: Config):
    z = x @ p["wz"].to(x.dtype)
    xin = x @ p["wx"].to(x.dtype)
    bproj = x @ p["wb"].to(x.dtype)
    cproj = x @ p["wc"].to(x.dtype)
    dt = x @ p["wdt"].to(x.dtype)
    return z, xin, bproj, cproj, dt


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, G, N) per-group B or C -> (B, heads, S, N), each group
    repeated over its heads (the reference's ``jnp.repeat``)."""
    bsz, s, g, n = t.shape
    t = t.permute(0, 2, 1, 3)[:, :, None]
    return t.expand(bsz, g, heads // g, s, n).reshape(bsz, heads, s, n)


def _ssd_heads(x, b, c, a, *, chunk: int, return_state: bool):
    """The ``ssd`` site on (B, H, L, *) operands: x (B, H, L, P), b/c
    (B, H, L, N), a (B, H, L) -> y (B, H, L, P) (and the final state
    (B, H, N, P)).  Under a mesh it runs on each rank's (batch, head)
    shards: the scan is independent per (batch, head)."""
    def scan(x, b, c, a):
        bsz, h, s, pdim = x.shape
        n = b.shape[-1]
        res = ops.ssd(x.reshape(bsz * h, s, pdim), b.reshape(bsz * h, s, n),
                      c.reshape(bsz * h, s, n), a.reshape(bsz * h, s),
                      chunk=chunk, return_state=return_state)
        if return_state:
            return (res[0].reshape(bsz, h, s, pdim),
                    res[1].reshape(bsz, h, n, pdim))
        return res.reshape(bsz, h, s, pdim)

    out = list(getattr(x, "placements", ()))
    return local_call(scan, (x, b, c, a),
                      (out, out) if return_state else out)


def ssm_apply(x, p, cfg: Config, chunk: int = None,
              return_state: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, D).

    With ``return_state``, also returns the decode cache for this layer:
    (h_final (B,H,N,P) f32, conv_state (B,W-1,conv_dim)) — the prefill
    path."""
    bsz, s, _ = x.shape
    chunk = chunk or cfg.ssm_chunk
    h, n, g, pdim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    z, xin, bp, cp, dt = _split_proj(x, p, cfg)
    xbc_raw = torch.cat([xin, bp, cp], dim=-1)
    xbc = F.silu(_causal_depthwise_conv(xbc_raw, p["conv_w"].to(x.dtype)))
    xin, bp, cp = torch.split(xbc, [cfg.d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float()) * dt              # (B, S, H) log-decay
    xh = split_last(xin, h, pdim)
    xs = xh * dt[..., None].to(xh.dtype)
    # the SSD operands head-sharded, as the reference constrains them
    heads = ("batch", "act_heads", None, None)
    res = _ssd_heads(constrain(xs.permute(0, 2, 1, 3), heads),
                     constrain(_heads(split_last(bp, g, n), h), heads),
                     constrain(_heads(split_last(cp, g, n), h), heads),
                     constrain(a.permute(0, 2, 1), heads[:3]),
                     chunk=chunk, return_state=return_state)
    y = res[0] if return_state else res
    y = y.permute(0, 2, 1, 3)                             # (B, S, H, P)
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, cfg.d_inner)
    y = constrain(rms_norm(y * F.silu(z), p["norm"]),
                  ("batch", None, "act_mlp"))
    out = y @ p["wo"].to(x.dtype)
    if return_state:
        conv_state = xbc_raw[:, -(cfg.conv_width - 1):]  # (B, W-1, conv_dim)
        return out, (res[1], conv_state)
    return out


def _ssm_step(xbc, dt, conv_state, conv_w, dt_bias, a_log, d_skip,
              h_state, cfg: Config, heads: Tuple[int, int], out_dtype):
    """One token's conv and recurrence on plain tensors: xbc (B, C) the
    conv input of every channel, dt (B, H) before its softplus, the conv
    state (B, W-1, C) and weights (W, C), the per-head parameters of every
    head, and the SSD state h_state (B, h1 - h0, N, P) of the heads
    ``heads`` = [h0, h1).  Returns (y (B, h1 - h0, P) in ``out_dtype``,
    the new state in f32, the new conv state (B, W-1, C))."""
    bsz = xbc.shape[0]
    hh, n, g, pdim = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    dtype = torch.promote_types(conv_state.dtype, xbc.dtype)
    hist = torch.cat([conv_state.to(dtype), xbc[:, None].to(dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, conv_w.to(dtype))
    new_conv = hist[:, 1:]
    xbc = F.silu(conv_out)
    xin, bp, cp = torch.split(xbc, [cfg.d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + dt_bias)                 # (B, H)
    a = -torch.exp(a_log.float()) * dt
    xh = xin.reshape(bsz, hh, pdim)
    xs = xh.float() * dt[..., None]
    bg = bp.reshape(bsz, g, n).repeat_interleave(hh // g, dim=1)  # (B, H, N)
    cg = cp.reshape(bsz, g, n).repeat_interleave(hh // g, dim=1)
    d_skip = d_skip.to(out_dtype)
    if tuple(heads) != (0, hh):
        h0, h1 = heads
        a, xh, xs = a[:, h0:h1], xh[:, h0:h1], xs[:, h0:h1]
        bg, cg, d_skip = bg[:, h0:h1], cg[:, h0:h1], d_skip[h0:h1]
    h_new = torch.exp(a)[..., None, None] * h_state.float() + \
        torch.einsum("bhn,bhp->bhnp", bg.float(), xs)
    y = torch.einsum("bhn,bhnp->bhp", cg.float(), h_new)
    y = y.to(out_dtype) + d_skip[None, :, None] * xh
    return y, h_new, new_conv


def ssm_decode(x, p, cfg: Config, state: Tuple[torch.Tensor, torch.Tensor]
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); state = (h (B,H,N,P), conv (B,W-1,C)).
    ``DTensor`` states: see the module docstring."""
    bsz = x.shape[0]
    h_state, conv_state = state
    z, xin, bp, cp, dt = _split_proj(x, p, cfg)
    per_head = (p["conv_w"], p["dt_bias"], p["a_log"], p["d_skip"])
    if not isinstance(h_state, DTensor):
        y, h_new, new_conv = _ssm_step(
            torch.cat([xin, bp, cp], dim=-1)[:, 0], dt[:, 0], conv_state,
            *per_head, h_state, cfg, (0, cfg.ssm_heads), x.dtype)
        y = y.reshape(bsz, 1, cfg.d_inner)
    else:
        mesh = h_state.device_mesh
        rows = [pl if pl.is_shard(0) else Replicate()
                for pl in h_state.placements]

        def whole(t, keep=rows):
            """t's local tensor, whole but for the kept batch split."""
            if not isinstance(t, DTensor):
                return t
            return (t if tuple(t.placements) == tuple(keep)
                    else t.redistribute(mesh, keep)).to_local()

        every = [Replicate()] * mesh.ndim
        heads = local_range(h_state, 1)
        y, h_new, new_conv = _ssm_step(
            torch.cat([whole(t)[:, 0] for t in (xin, bp, cp)], dim=-1),
            whole(dt)[:, 0], whole(conv_state),
            *(whole(t, every) for t in per_head), h_state.to_local(), cfg,
            heads, x.dtype)
        # the output's channels split as the heads, the state as it was
        y = DTensor.from_local(
            y.reshape(y.shape[0], 1, -1), mesh,
            [Shard(2) if pl.is_shard(1) else pl for pl in h_state.placements],
            shape=torch.Size((bsz, 1, cfg.d_inner)),
            stride=(cfg.d_inner, cfg.d_inner, 1))
        h_new = DTensor.from_local(h_new, mesh, h_state.placements,
                                   shape=h_state.shape,
                                   stride=h_state.stride())
        c0, c1 = local_range(conv_state, 2)
        new_conv = DTensor.from_local(
            new_conv[..., c0:c1], mesh, conv_state.placements,
            shape=conv_state.shape, stride=conv_state.stride())
    y = rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["wo"].to(x.dtype)
    return out, (h_new.to(h_state.dtype), new_conv)
