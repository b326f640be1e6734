"""Bilinear resize with torch ``align_corners=False`` semantics and the
torch-style nearest resize (port of ``spike2former_tpu/ops/resize.py``:
``resize_bilinear``, ``resize_bilinear_hw``, ``resize_nearest_torch``).

The JAX package gathers by hand because ``jax.image.resize`` antialiases on
downscale; here ``F.interpolate`` (no antialias) is the function itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_hw(x: torch.Tensor, out_hw: tuple[int, int]
                       ) -> torch.Tensor:
    """Resize the LAST TWO axes (``[..., H, W]``, channels-first)."""
    *lead, h, w = x.shape
    if (h, w) == tuple(out_hw):
        return x
    y = F.interpolate(x.reshape(-1, 1, h, w), size=tuple(out_hw),
                      mode="bilinear", align_corners=False)
    return y.reshape(*lead, *out_hw)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize ``[..., H, W, C]`` (channels-last)."""
    *lead, h, w, c = x.shape
    if (h, w) == tuple(out_hw):
        return x
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c)


def resize_nearest_torch(x: torch.Tensor, out_hw: tuple[int, int]
                         ) -> torch.Tensor:
    """Nearest resize of ``[..., H, W, C]`` as torch
    ``F.interpolate(mode='nearest')`` does it: ``src = floor(dst * in/out)``
    (asymmetric, not half-pixel), computed in f32 as the JAX package does.
    Integer factors take a strided slice (downscale) or pixel repetition
    (upscale); any dtype, integer maps included."""
    *lead, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return x[..., ::h // oh, ::w // ow, :]
    if oh % h == 0 and ow % w == 0:
        return x.repeat_interleave(oh // h, -3).repeat_interleave(ow // w, -2)
    ys = torch.floor(torch.arange(oh, dtype=torch.float32) * (h / oh))
    xs = torch.floor(torch.arange(ow, dtype=torch.float32) * (w / ow))
    ys = ys.long().clamp(max=h - 1).to(x.device)
    xs = xs.long().clamp(max=w - 1).to(x.device)
    return x[..., ys[:, None], xs[None, :], :]
