"""Sine positional encoding, DETR style (port of
``spike2former_tpu/models/positional.py``)."""
from __future__ import annotations

import math

import torch

from ..parallel import spatial


def sine_positional_encoding(mask: torch.Tensor, num_feats: int = 128,
                             temperature: float = 10000.0,
                             normalize: bool = True,
                             scale: float = 2 * math.pi, eps: float = 1e-6,
                             offset: float = 0.0) -> torch.Tensor:
    """mask [B, H, W] (1 = padded) -> [B, H, W, 2*num_feats] channels-last."""
    not_mask = 1.0 - mask.float()
    y_embed = torch.cumsum(not_mask, 1)
    x_embed = torch.cumsum(not_mask, 2)
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    b, h, w = mask.shape
    pos_x = torch.stack((pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()),
                        4).reshape(b, h, w, -1)
    pos_y = torch.stack((pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()),
                        4).reshape(b, h, w, -1)
    return torch.cat((pos_y, pos_x), 3)


def sine_pe_for_shape(h: int, w: int, num_feats: int = 128,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """All-valid-mask PE for (h, w): [h, w, 2*num_feats]; inside
    ``parallel.spatial_sharding()``, for a row band of ``h`` rows, the
    whole map's PE's rows of the band."""
    bands = spatial.bands()
    rows = h * (bands.size if bands else 1)
    mask = torch.zeros((1, rows, w), dtype=torch.float32, device=device)
    pe = sine_positional_encoding(mask, num_feats)[0]
    if bands is None:
        return pe
    r0, _ = spatial.rows(h)
    return pe[r0:r0 + h]
