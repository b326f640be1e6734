"""Multi-scale deformable attention sampling (port of
``spike2former_tpu/ops/msda.py``; mmcv's ``ms_deform_attn`` and its
``multi_scale_deformable_attn_pytorch`` fallback).

The JAX package builds each sample as a two-tap row/column selector
contraction per pyramid level, a TPU formulation (no gathers); here it is
``F.grid_sample`` per level, the function mmcv's fallback computes:
bilinear, ``align_corners=False``, zero padding outside the map.  The
sampled values are weighted and summed in float32 and returned in the
value's dtype.  Used by ``models/deformable.py``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, sum(H*W), heads, dim] (the levels' maps flattened in
    order); sampling_locations [B, Nq, heads, L, P, 2] normalized (x, y)
    in [0, 1] (outside it the taps read zeros); attention_weights
    [B, Nq, heads, L, P] -> [B, Nq, heads*dim] in ``value.dtype``."""
    b, _, heads, dim = value.shape
    nq, p = sampling_locations.shape[1], sampling_locations.shape[4]
    out = value.new_zeros((b * heads, dim, nq), dtype=torch.float32)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].float()
        start += h * w
        v = v.reshape(b, h, w, heads, dim).permute(0, 3, 4, 1, 2).reshape(
            b * heads, dim, h, w)
        grid = sampling_locations[:, :, :, lvl].float() * 2 - 1
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * heads, nq, p, 2)
        taps = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)      # [B*heads, dim, Nq, P]
        wgt = attention_weights[:, :, :, lvl].float().permute(0, 2, 1, 3)
        out = out + (taps * wgt.reshape(b * heads, 1, nq, p)).sum(-1)
    return out.reshape(b, heads, dim, nq).permute(0, 3, 1, 2).reshape(
        b, nq, heads * dim).to(value.dtype)
