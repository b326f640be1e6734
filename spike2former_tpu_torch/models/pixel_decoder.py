"""DCN pixel decoder (port of ``spike2former_tpu/models/pixel_decoder.py``:
``DCNEncoderLayer``, ``DCNPixelDecoder``).

The /16 level runs through layer-scaled SepConv_Spike -> DCNv3 -> MS_MLP
encoder layers, then a top-down spiking FPN builds the /8, /4 and /2 maps.
Returns (mask_feature [T,B,H/2,W/2,out], memory [T,B,H/16,W/16,feat],
multi_scale [/16, /8, /4]).  ``dtype`` is the convolutions' compute dtype;
``remat`` recomputes each encoder layer in the backward (its BN running
statistics move once, ``layers.remat``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .attention import MSDAFFN
from .dcn import DCNv3
from .layers import (BatchNorm, ConvBN, SepConv, Spike, conv2d, conv_nhwc,
                     fold_t, remat, unfold_t)


class DCNEncoderLayer(nn.Module):
    """x += g1*SepConv(x); x += g2*DCNv3(x); x += g3*FFN(x)
    (detr_layers.py:301,329-339; gammas start at 1e-6)."""

    def __init__(self, embed_dims: int = 256,
                 feedforward_channels: int = 1024, group: int = 32,
                 dw_kernel_size: int = 5, layer_scale: float = 1e-6,
                 compat: bool = False, dtype=torch.float32):
        super().__init__()
        for name in ("gamma1", "gamma2", "gamma3"):
            setattr(self, name,
                    nn.Parameter(torch.full((embed_dims,), layer_scale)))
        self.conv = SepConv(embed_dims, kernel_size=3, padding=1, dw_bn=True,
                            num_spikes=3, dtype=dtype)
        self.dcn = DCNv3(channels=embed_dims, group=group,
                         dw_kernel_size=dw_kernel_size, compat=compat,
                         dtype=dtype)
        self.ffn = MSDAFFN(embed_dims, feedforward_channels, compat=compat,
                           dtype=dtype)

    def forward(self, x):
        x = x + self.gamma1 * self.conv(x)
        x = x + self.gamma2 * self.dcn(x)
        return x + self.gamma3 * self.ffn(x)


class DCNPixelDecoder(nn.Module):
    """DCNTransformerEncoderPixelDecoder (pixel_decoder.py:316-472)."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 360),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_encoder_layers: int = 6,
                 feedforward_channels: int = 1024, group: int = 32,
                 dw_kernel_size: int = 5, compat: bool = False,
                 remat: bool = False, dtype=torch.float32):
        super().__init__()
        c = feat_channels
        dt = dict(dtype=dtype)
        self.num_inputs = len(in_channels)
        self.num_encoder_layers = num_encoder_layers
        self.remat = remat
        self.in_spike, self.out_spike = Spike(), Spike()
        self.encoder_in_proj = ConvBN(in_channels[-1], c, 1, bias=True, **dt)
        for i in range(num_encoder_layers):
            setattr(self, f"encoder_{i}", DCNEncoderLayer(
                c, feedforward_channels, group, dw_kernel_size,
                compat=compat, **dt))
        self.encoder_out_proj = ConvBN(c, c, 1, bias=True, **dt)
        for idx, i in enumerate(range(self.num_inputs - 2, -1, -1)):
            setattr(self, f"lateral_spike_{idx}", Spike())
            setattr(self, f"output_spike_{idx}", Spike())
            setattr(self, f"lateral_{idx}",
                    ConvBN(in_channels[i], c, 1, bias=True, **dt))
            setattr(self, f"output_conv_{idx}",
                    conv2d(c, c, 3, pad=1, groups=c, **dt))
            setattr(self, f"output_bn_{idx}", BatchNorm(c))
        self.mask_spike = Spike()
        self.mask_feature = conv2d(c, out_channels, 1, bias=True, **dt)

    def forward(self, feats: Sequence[torch.Tensor]):
        t = feats[-1].shape[0]
        xf = self.encoder_in_proj(self.in_spike(fold_t(feats[-1])[0]))
        x = unfold_t(xf, t)
        for i in range(self.num_encoder_layers):
            layer = getattr(self, f"encoder_{i}")
            x = remat(layer, x) if self.remat else layer(x)
        memory = self.out_spike(x)
        y = self.encoder_out_proj(fold_t(memory)[0])

        outs = [unfold_t(y, t)]
        for idx, i in enumerate(range(self.num_inputs - 2, -1, -1)):
            lf = getattr(self, f"lateral_spike_{idx}")(fold_t(feats[i])[0])
            cur = getattr(self, f"lateral_{idx}")(lf)
            y = cur + resize_bilinear(y, tuple(cur.shape[1:3]))
            y = getattr(self, f"output_spike_{idx}")(y)
            y = conv_nhwc(getattr(self, f"output_conv_{idx}"), y)
            y = getattr(self, f"output_bn_{idx}")(y)
            outs.append(unfold_t(y, t))

        mask_feature = conv_nhwc(self.mask_feature, self.mask_spike(y))
        return unfold_t(mask_feature, t), memory, outs[:3]
