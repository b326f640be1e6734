"""Bilinear resize with torch ``align_corners=False`` semantics and the
torch-style nearest resize (port of ``spike2former_tpu/ops/resize.py``:
``resize_bilinear``, ``resize_bilinear_hw``, ``resize_nearest_torch``).

The JAX package gathers by hand because ``jax.image.resize`` antialiases on
downscale; here ``F.interpolate`` (no antialias) is the function itself, in
float32.  In a lower precision (a bf16 model's activations and logits) the
bilinear resizes compute what JAX's do in that dtype, rounding where they
round (``_resize_lowp``): the spikes after an upsample turn on its last
bit.

Inside ``parallel.spatial_sharding()`` the two bilinear resizes take a row band
and upsample it by a power of two with one halo row from each
neighbouring band, or downscale it by an integer factor from its own
rows (``_band_resize``): the rows they give are the whole map's, bit for
bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial


@functools.lru_cache(maxsize=64)
def _linear_weights(n_in: int, n_out: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """[n_in, n_out] half-pixel bilinear weights as ``jax.image.resize``
    builds them (``compute_weight_mat`` with the triangle kernel, no
    antialias) in float32, then cast to ``dtype`` on ``device`` (kept per
    shape: a request or a step asks for the same few; made outside
    inference mode, so that a step may use what a request made)."""
    with torch.inference_mode(False):
        return _weights(n_in, n_out).to(device, dtype)


def _weights(n_in: int, n_out: int) -> torch.Tensor:
    inv = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :]
            - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@functools.lru_cache(maxsize=64)
def _half_pixel_grid(n_in: int, n_out: int, device: torch.device,
                     dtype: torch.dtype):
    """Floor taps and fractions (in ``dtype``) of torch's
    ``align_corners=False`` grid, clamped into the map, as the JAX
    package's gather path takes them, on ``device`` (outside inference
    mode, as ``_linear_weights``)."""
    with torch.inference_mode(False):
        s = ((torch.arange(n_out, dtype=torch.float32) + 0.5)
             * (n_in / n_out) - 0.5).clamp(0.0, n_in - 1)
        i0 = torch.floor(s).long()
        return tuple(t.to(device) for t in (
            i0, torch.clamp(i0 + 1, max=n_in - 1), (s - i0).to(dtype)))


def _resize_lowp(x: torch.Tensor, out_hw: tuple[int, int], ax: int,
                 whole: tuple[int, int] | None = None) -> torch.Tensor:
    """Bilinear resize of axes ``ax``, ``ax + 1`` of ``x`` in its own
    dtype, as the JAX package computes it there: a pure upscale is
    ``jax.image.resize``, one product per axis with the weights in
    ``x.dtype``, f32 sums rounded after each, the axes in the order that
    its einsum takes (the one of fewer operations; H first on a tie);
    anything else is its gather with the fractions in ``x.dtype`` and each
    product and sum rounded (ops/resize.py:34-52, 72-90).  ``whole``:
    the (input, output) heights whose order a row band follows."""
    ax = ax % x.dim()
    h, w = x.shape[ax], x.shape[ax + 1]
    oh, ow = out_hw
    wh, woh = whole or (h, oh)
    dev, dt = x.device, x.dtype
    if oh >= h and ow >= w:
        def along(t, n_out, a):
            wm = _linear_weights(t.shape[a], n_out, dev, dt)
            return (t.movedim(a, -1) @ wm).movedim(-1, a)

        if woh * w * (wh + ow) <= wh * ow * (w + woh):
            return along(along(x, oh, ax), ow, ax + 1)
        return along(along(x, ow, ax + 1), oh, ax)
    y0, y1, wy = _half_pixel_grid(h, oh, dev, dt)
    x0, x1, wx = _half_pixel_grid(w, ow, dev, dt)
    tail = (1,) * (x.dim() - ax - 2)
    wy = wy.view(-1, 1, *tail)
    wx = wx.view(-1, *tail)

    def gather(yi, xi):
        return x.index_select(ax, yi).index_select(ax + 1, xi)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _band_resize(x: torch.Tensor, out_hw: tuple[int, int], ax: int,
                 resize) -> torch.Tensor:
    """``resize`` of this rank's row band (axis ``ax``) inside
    ``parallel.spatial_sharding()``.

    An upsample by a power of two (its half-pixel grid is then exact)
    takes the band with one row of each neighbouring band (none at the
    map's top and bottom, where the resize clamps), and is cut to the
    band's output rows.  A downscale by an integer factor ``f`` needs no
    halo: output row ``i`` samples at ``f*i + f/2 - 1/2``, so its taps
    (rows ``f*i + f/2 - 1`` and ``f*i + f/2``, or the one row ``f*i +
    (f-1)/2`` for an odd ``f``) lie in its own block of ``f`` rows, which
    the band holds whole; the band's grid has the whole map's fractions."""
    ax = ax % x.dim()
    h, oh = x.shape[ax], out_hw[0]
    size = spatial.bands().size
    whole = (h * size, oh * size)
    if oh < h:
        if h % oh:
            raise ValueError(f"a band of {h} rows resized to {oh}: spatial "
                             "sharding downscales by integer factors")
        return resize(x, out_hw, whole)
    f = oh // h
    if oh != f * h or f & (f - 1):
        raise ValueError(f"a band of {h} rows resized to {oh}: spatial "
                         "sharding upsamples by powers of two")
    ext, top = spatial.halo(x, ax, 1, 1, edge="none")
    y = resize(ext, (ext.shape[ax] * f, out_hw[1]), whole)
    return y.narrow(ax, top * f, oh)


def resize_bilinear_hw(x: torch.Tensor, out_hw: tuple[int, int]
                       ) -> torch.Tensor:
    """Resize the LAST TWO axes (``[..., H, W]``, channels-first)."""
    if spatial.bands() is not None and x.shape[-2] != out_hw[0]:
        return _band_resize(x, out_hw, -2, _resize_hw)
    return _resize_hw(x, out_hw)


def _resize_hw(x: torch.Tensor, out_hw: tuple[int, int],
               whole: tuple[int, int] | None = None) -> torch.Tensor:
    *lead, h, w = x.shape
    if (h, w) == tuple(out_hw):
        return x
    if x.dtype != torch.float32:
        return _resize_lowp(x, out_hw, -2, whole)
    y = F.interpolate(x.reshape(-1, 1, h, w), size=tuple(out_hw),
                      mode="bilinear", align_corners=False)
    return y.reshape(*lead, *out_hw)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]
                                  ) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W, C]`` (channels-last) with
    ``align_corners=True``: output pixel ``i`` samples input coordinate
    ``i * (H - 1) / (oh - 1)`` (0 for a single output row), as JAX's
    (resize.py:95-122)."""
    *_, h, w, _ = x.shape
    oh, ow = out_hw
    dev = x.device

    def grid(n_in, n_out):
        if n_out == 1:
            return torch.zeros(1, device=dev)
        return torch.arange(n_out, dtype=torch.float32, device=dev) * (
            (n_in - 1) / (n_out - 1))

    ys, xs = grid(h, oh), grid(w, ow)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    ax = x.dim() - 3

    def gather(yi, xi):
        return x.index_select(ax, yi).index_select(ax + 1, xi)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize ``[..., H, W, C]`` (channels-last)."""
    if spatial.bands() is not None and x.shape[-3] != out_hw[0]:
        return _band_resize(x, out_hw, -3, _resize_hwc)
    return _resize_hwc(x, out_hw)


def _resize_hwc(x: torch.Tensor, out_hw: tuple[int, int],
                whole: tuple[int, int] | None = None) -> torch.Tensor:
    *lead, h, w, c = x.shape
    if (h, w) == tuple(out_hw):
        return x
    if x.dtype != torch.float32:
        return _resize_lowp(x, out_hw, -3, whole)
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
