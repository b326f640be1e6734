"""Point-sampled mask losses' samplers (port of
``spike2former_tpu/losses/point_sample.py``; reference:
mmdet/models/utils/point_sample.py:1-88).

``point_sample`` is mmcv's op: bilinear ``grid_sample`` with
``align_corners=False`` and zero padding at normalized (x, y) coordinates
in [0, 1]^2 (source coordinate ``p * size - 0.5``; a neighbour outside the
map contributes 0).  The JAX package builds it from one-hot selector
matmuls and packs slot ids into a 2x2 table because scalar gathers
serialize on a TPU; here each point gathers its four taps, and the mask
gradient is the gather's scatter-add.

The taps are combined in the JAX package's separable order,
``cx0 * (ry0 * m[y0, x0] + ry1 * m[y1, x0]) + cx1 * (...)``, in float32.
With ``dtype=torch.bfloat16`` the mask values and the row weights ``ry``
are rounded to bfloat16 first, as JAX's bf16 selector contraction rounds
its operands (the column weights and the sums stay float32): the
uncertainty ranking and the GT targets of the train criterion are taken
that way, and the ranking decides which points the loss sees.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..parallel.mesh import global_block
from ..utils import jax_random as jr

# uniform [0, 1) draws of a given shape: the point coordinates' source
Draw = Callable[[tuple], torch.Tensor]


def _corner(coords: torch.Tensor, h: int, w: int):
    """Top-left tap (y0, x0) as int64 and the fractions (wy, wx) in f32 of
    normalized (x, y) ``coords`` [..., P, 2]."""
    x = coords[..., 0].float() * w - 0.5
    y = coords[..., 1].float() * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    return y0.long(), x0.long(), y - y0, x - x0


def _taps(y0: torch.Tensor, x0: torch.Tensor, h: int, w: int):
    """The 4 taps of each point, in the order (0,0), (0,1), (1,0), (1,1):
    (flat index into [H*W], clamped into the map; in-bounds)."""
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + dy, x0 + dx
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yield yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1), inb


def _gather_taps(flat: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 h: int, w: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``flat`` [N, H*W] at the 4 taps of each point (y0, x0 [N, P]):
    (values [N, P], in-bounds) in ``_taps``' order."""
    return [(flat.gather(1, idx), inb) for idx, inb in _taps(y0, x0, h, w)]


def _product_weights(wy: torch.Tensor, wx: torch.Tensor) -> tuple:
    """The bilinear weights of the 4 taps as products, in ``_taps``'
    order (the JAX package's ``_taps``)."""
    return ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)


def _separable(taps, wy: torch.Tensor, wx: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``cx0 * (ry0 * v00 + ry1 * v10) + cx1 * (ry0 * v01 + ry1 * v11)``
    in f32, with out-of-bounds taps 0 and ``ry`` rounded to ``dtype``."""
    ry0, ry1 = ((1.0 - wy).to(dtype).float(), wy.to(dtype).float())
    v00, v01, v10, v11 = (v.to(dtype).float() * inb for v, inb in taps)
    return (1.0 - wx) * (ry0 * v00 + ry1 * v10) + wx * (ry0 * v01
                                                       + ry1 * v11)


def point_sample(masks: torch.Tensor, coords: torch.Tensor, *,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """mmcv ``point_sample``: masks [..., H, W] at coords [..., P, 2]
    (normalized (x, y) in [0, 1], the same leading dims) -> [..., P]
    float32, differentiable in ``masks``.  ``dtype`` (float32 by default,
    or bfloat16) is the JAX contraction's operand dtype: the mask values
    and row weights are rounded to it."""
    *lead, h, w = masks.shape
    p = coords.shape[-2]
    n = math.prod(lead)
    y0, x0, wy, wx = _corner(coords.reshape(n, p, 2), h, w)
    taps = _gather_taps(masks.reshape(n, h * w), y0, x0, h, w)
    out = _separable(taps, wy, wx, dtype or torch.float32)
    return out.reshape(*lead, p)


def point_sample_shared(masks: torch.Tensor, coords: torch.Tensor
                        ) -> torch.Tensor:
    """Every mask of a stack at ONE point set per image: masks
    [B, Q, H, W], coords [B, P, 2] -> [B, Q, P] float32.  The taps sum in
    the JAX function's order, with the product weights
    ``(1 - wy)(1 - wx)``, ``(1 - wy) wx``, ``wy (1 - wx)``, ``wy wx``."""
    b, q, h, w = masks.shape
    p = coords.shape[-2]
    y0, x0, wy, wx = _corner(coords.reshape(b, p, 2), h, w)
    flat = masks.float().reshape(b, q, h * w)
    out = torch.zeros((b, q, p), dtype=torch.float32, device=masks.device)
    for (idx, inb), wgt in zip(_taps(y0, x0, h, w),
                               _product_weights(wy, wx)):
        v = flat.gather(2, idx[:, None].expand(b, q, p))
        out = out + torch.where(inb[:, None], v, 0.0) * wgt[:, None]
    return out


def point_sample_slot(slot_map: torch.Tensor, num_slots: int,
                      coords: torch.Tensor, *,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Every slot's binary mask of a slot map, bilinearly sampled, without
    the dense masks: slot_map [B, H, W] int (pixel -> slot, ``num_slots``
    = none); coords [B, P, 2] (shared by the slots) or [B, G, P, 2]
    (per pair) -> [B, G, P] float32, equal to ``point_sample`` of the
    dense {0, 1} masks.  Shared points take the product weights, as the
    JAX function's packed-table path; per-pair points ``point_sample``'s
    separable form at ``dtype``."""
    b, h, w = slot_map.shape
    g = num_slots
    flat = slot_map.reshape(b, h * w)
    slots = torch.arange(g, device=slot_map.device)
    if coords.dim() == 4:
        p = coords.shape[-2]
        y0, x0, wy, wx = _corner(coords.reshape(b, g * p, 2), h, w)
        taps = [((sid.reshape(b, g, p) == slots[None, :, None]).float(),
                 inb.reshape(b, g, p))
                for sid, inb in _gather_taps(flat, y0, x0, h, w)]
        return _separable(taps, wy.reshape(b, g, p), wx.reshape(b, g, p),
                          dtype or torch.float32)
    p = coords.shape[-2]
    y0, x0, wy, wx = _corner(coords, h, w)
    out = torch.zeros((b, g, p), dtype=torch.float32, device=slot_map.device)
    for (sid, inb), wgt in zip(_gather_taps(flat, y0, x0, h, w),
                               _product_weights(wy, wx)):
        hit = (sid[:, None, :] == slots[None, :, None]) & inb[:, None, :]
        out = out + torch.where(hit, 1.0, 0.0) * wgt[:, None, :]
    return out


def get_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """Class-agnostic uncertainty: ``-|logit|``."""
    return -logits.abs()


def keyed_uniform(key: jr.Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` on ``device``; inside
    ``global_batch()`` this rank's rows (axis 0) of the global batch's
    draw."""
    full, start, stop = global_block(shape, 0)
    return jr.uniform(key, full, start=start, stop=stop, device=device)


def point_draw(rng: jr.Key, num_layers: int, draws_per_layer: int,
               device) -> Draw:
    """The ``Draw`` of JAX's point keys (criterion.py:605-616,
    point_sample.py:262-271) in ``maskformer_loss``'s order of calls:
    layer ``l``'s matching points from ``split(fold_in(rng, 0), L)[l]``,
    then its oversampled and fresh loss points from ``r1, r2 =
    split(split(fold_in(rng, 1), L)[l])`` (``r1`` only where
    ``draws_per_layer`` is 1: no fresh points)."""
    match = jr.split(jr.fold_in(rng, 0), num_layers)
    loss = jr.split(jr.fold_in(rng, 1), num_layers)
    keys = iter(match + [k for lk in loss
                         for k in jr.split(lk)[:draws_per_layer]])
    return lambda shape: keyed_uniform(next(keys), shape, device)


def uncertain_point_coords(mask_logits: torch.Tensor, num_points: int,
                           oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75, *,
                           draw: Draw, dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """``get_uncertain_point_coords_with_randomness`` (point_sample.py:
    34-88): ``num_points * oversample_ratio`` uniform points, of which the
    ``importance_sample_ratio`` fraction with the most uncertain sampled
    logits (``point_sample`` at ``dtype``) are kept, the rest replaced by
    fresh uniforms.  mask_logits [..., H, W] (no gradient is taken) ->
    coords [..., num_points, 2].

    ``draw(shape)`` supplies the uniforms: first the oversampled points
    [..., n, 2], then the fresh ones.  The selection is a stable sort by
    ``|logit|``, ties in their drawing order, as JAX's ``lax.sort``."""
    if oversample_ratio < 1 or not 0 <= importance_sample_ratio <= 1:
        raise ValueError("need oversample_ratio >= 1 and "
                         "0 <= importance_sample_ratio <= 1")
    lead = tuple(mask_logits.shape[:-2])
    n_sampled = int(num_points * oversample_ratio)
    n_imp = int(importance_sample_ratio * num_points)
    n_rand = num_points - n_imp
    coords = draw((*lead, n_sampled, 2)).to(mask_logits.device)
    with torch.no_grad():
        unc = get_uncertainty(point_sample(mask_logits.detach(), coords,
                                           dtype=dtype))
        order = torch.sort(-unc, dim=-1, stable=True).indices[..., :n_imp]
    sel = coords.gather(-2, order[..., None].expand(*order.shape, 2))
    if n_rand > 0:
        sel = torch.cat([sel, draw((*lead, n_rand, 2)).to(sel.device)], -2)
    return sel
