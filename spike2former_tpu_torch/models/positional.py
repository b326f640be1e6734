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
                             offset: float = 0.0,
                             rows: tuple[int, int] | None = None
                             ) -> torch.Tensor:
    """mask [B, H, W] (1 = padded) -> [B, H, W, 2*num_feats] channels-last;
    with ``rows`` = (r0, r1) only those rows of it, [B, r1 - r0, W, ...]:
    the cumulative sums and their totals still run over the whole mask."""
    not_mask = 1.0 - mask.float()
    y_embed = torch.cumsum(not_mask, 1)
    x_embed = torch.cumsum(not_mask, 2)
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, :, -1:] + eps) * scale
    if rows is not None:
        y_embed, x_embed = (e[:, rows[0]:rows[1]] for e in (y_embed, x_embed))
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    b, h, w = y_embed.shape
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
    mask = torch.zeros((1, h * (bands.size if bands else 1), w),
                       dtype=torch.float32, device=device)
    return sine_positional_encoding(mask, num_feats, rows=spatial.band_rows(h))[0]
