"""Spiking multi-scale deformable attention and the Deformable-DETR
encoder (port of ``spike2former_tpu/models/deformable.py``; reference
mmdet/models/layers/transformer/mmcv_spike/multi_scale_deform_attn.py:
175-414 and deformable_detr_layers.py:23-400).

``SpikeMSDeformAttention`` projects its value, sampling offsets and
attention weights with spike -> pointwise conv -> BN heads (multispike
quantizers), and passes the attention weights, scaled by ``C^-0.5``,
through a spike instead of a softmax; the sampling is ``ops/msda.py``.
``SpikeDeformableEncoderLayer`` adds it and an ``MSDAFFN`` to its input
with layer-scale (1e-6) residuals.  No preset builds these modules, in
either package.  Tokens are ``[T, B, N, C]``; submodules carry the flax
names, so ``engine/convert.py:from_jax_variables`` maps JAX's variables.

Inside ``parallel.spatial_sharding()`` the tokens are this rank's row
band of each level (``spatial_shapes`` the bands' shapes), concatenated
level by level: the sampling may read anywhere in every level, so each
level's value map is gathered whole, and the reference points and the
offsets' normalisation are the whole maps'.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.msda import ms_deform_attn
from ..parallel import spatial
from . import initializers as init
from .attention import MSDAFFN, TokenConvBN
from .layers import Spike, unfold_t


def encoder_reference_points(spatial_shapes: Sequence[tuple[int, int]],
                             device=None) -> torch.Tensor:
    """Each level's pixel centres normalized to [0, 1]
    (deformable_detr_layers.py get_encoder_reference_points, valid ratios
    1), for every level: [sum(H*W), L, 2] (x, y) float32."""
    refs = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        refs.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.from_numpy(np.concatenate(refs, 0)).to(device)
    return ref[:, None].expand(-1, len(spatial_shapes), -1)


def _whole_shapes(spatial_shapes: Sequence[tuple[int, int]]
                  ) -> list[tuple[int, int]]:
    """The levels' whole shapes: ``spatial_shapes`` outside
    ``parallel.spatial_sharding()``, the bands' heights times their count
    inside it."""
    b = spatial.bands()
    return [(h * (b.size if b else 1), w) for h, w in spatial_shapes]


def _gather_levels(val: torch.Tensor,
                   spatial_shapes: Sequence[tuple[int, int]]
                   ) -> torch.Tensor:
    """[B, sum(h*w), ...] tokens of the levels' row bands -> the whole
    levels' [B, sum(H*W), ...] (every band's rows of each level, in
    order)."""
    parts, start = [], 0
    for h, w in spatial_shapes:
        lvl = val[:, start:start + h * w]
        start += h * w
        lvl = spatial.gather_rows_h(lvl.unflatten(1, (h, w)), 1)
        parts.append(lvl.flatten(1, 2))
    return torch.cat(parts, 1)


def _band_tokens(x: torch.Tensor,
                 spatial_shapes: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Of the whole levels' tokens ``x`` [sum(H*W), ...], this rank's row
    band of each level, in order."""
    parts, start = [], 0
    for h, w in spatial_shapes:
        r0, r1 = spatial.rows(h)
        parts.append(x[start + r0 * w:start + r1 * w])
        start += h * spatial.bands().size * w
    return torch.cat(parts, 0)


class SpikeMSDeformAttention(nn.Module):
    """query [T, B, Nq, C], value [T, B, Nv, C]; reference_points [Nq, L, 2]
    or [T*B, Nq, L, 2] normalized (x, y); ``spatial_shapes`` the levels'
    (H, W) in the value's order -> [T, B, Nq, C].  Inside
    ``parallel.spatial_sharding()`` the value is the levels' row bands
    (``spatial_shapes`` theirs), each gathered whole, and the reference
    points are the queries' own, normalized by the whole maps."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 spike: str = "multispike_norm", dtype=torch.float32):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        hlp = num_heads * num_levels * num_points
        self.Spike_0 = Spike(spike)         # the projected value
        self.value_proj = TokenConvBN(embed_dims, embed_dims, dtype, spike)
        self.sampling_offsets = TokenConvBN(embed_dims, hlp * 2, dtype,
                                            spike)
        self.attention_weights = TokenConvBN(embed_dims, hlp, dtype, spike)
        self.Spike_1 = Spike(spike)         # the weights, for a softmax
        self.output_proj = TokenConvBN(embed_dims, embed_dims, dtype, spike)

    def forward(self, query, value, reference_points, spatial_shapes,
                query_pos=None):
        t, b, nq, c = query.shape
        h, lv, p = self.num_heads, self.num_levels, self.num_points
        if query_pos is not None:
            query = query + query_pos
        val = self.Spike_0(self.value_proj(value))
        val = val.reshape(t * b, value.shape[2], h, c // h)
        if spatial.bands() is not None:
            val = _gather_levels(val, spatial_shapes)
            spatial_shapes = _whole_shapes(spatial_shapes)
        off = self.sampling_offsets(query).reshape(t * b, nq, h, lv, p, 2)
        wgt = self.Spike_1(self.attention_weights(query)
                           * self.embed_dims ** -0.5)
        wgt = wgt.reshape(t * b, nq, h, lv, p)
        ref = torch.as_tensor(reference_points, dtype=torch.float32,
                              device=query.device)
        if ref.dim() == 3:
            ref = ref[None]
        norm = torch.tensor([(w, hh) for hh, w in spatial_shapes],
                            dtype=torch.float32, device=query.device)
        loc = ref[:, :, None, :, None, :] + off / norm[:, None, :]
        out = ms_deform_attn(val, spatial_shapes, loc, wgt)
        return self.output_proj(unfold_t(out.reshape(t * b, nq, c), t))


class SpikeDeformableEncoderLayer(nn.Module):
    """x += g1 * MSDeformAttn(x); x += g2 * MSDA_FFN(x), the gammas starting
    at ``layer_scale`` (deformable_detr_layers.py:357-400)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 feedforward_channels: int = 1024,
                 layer_scale: float = 1e-6, spike: str = "multispike_norm",
                 dtype=torch.float32):
        super().__init__()
        self.gamma1 = nn.Parameter(torch.full((embed_dims,), layer_scale))
        self.gamma2 = nn.Parameter(torch.full((embed_dims,), layer_scale))
        # flax's constant(layer_scale) (JAX deformable.py:119-121)
        self.init_laws = {name: init.constant(layer_scale)
                          for name in ("gamma1", "gamma2")}
        self.self_attn = SpikeMSDeformAttention(
            embed_dims, num_heads, num_levels, num_points, spike, dtype)
        self.ffn = MSDAFFN(embed_dims, feedforward_channels, dtype=dtype)

    def forward(self, query, reference_points, spatial_shapes,
                query_pos=None):
        query = query + self.gamma1 * self.self_attn(
            query, query, reference_points, spatial_shapes, query_pos)
        return query + self.gamma2 * self.ffn(query)


class SpikeDeformableEncoder(nn.Module):
    """``num_layers`` deformable encoder layers over the flattened tokens of
    the levels ``spatial_shapes`` (SpikeDeformableDetrTransformerEncoder,
    deformable_detr_layers.py:23-75); the number of levels is that of the
    shapes each call is given, ``num_levels`` here."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = 8, num_points: int = 4,
                 feedforward_channels: int = 1024, num_levels: int = 4,
                 spike: str = "multispike_norm", dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_{i}", SpikeDeformableEncoderLayer(
                embed_dims, num_heads, num_levels, num_points,
                feedforward_channels, spike=spike, dtype=dtype))

    def forward(self, query, spatial_shapes, query_pos=None):
        ref = encoder_reference_points(_whole_shapes(spatial_shapes),
                                       query.device)
        if spatial.bands() is not None:
            # the band's tokens of each level
            ref = _band_tokens(ref, spatial_shapes)
        for i in range(self.num_layers):
            query = getattr(self, f"layer_{i}")(query, ref, spatial_shapes,
                                                query_pos)
        return query
