"""Pixel decoders (port of ``spike2former_tpu/models/pixel_decoder.py``:
``DCNEncoderLayer``, ``DCNPixelDecoder``, ``TransformerEncoderPixelDecoder``,
``FPNPixelDecoder``).

In the DCN decoder (the one the MaskFormer head builds) the /16 level runs
through layer-scaled SepConv_Spike -> DCNv3 -> MS_MLP encoder layers, then
a top-down spiking FPN builds the /8, /4 and /2 maps.  The Transformer
decoder encodes the /16 level with softmax-free spiking MHA + MSDA_FFN
layers and a sine PE instead; the FPN decoder has no encoder (a plain
spiking FPN, nearest top-down).  No config key builds the last two, in
either package.  Each returns (mask_feature [T,B,H',W',out], memory
[T,B,H/16,W/16,C], multi_scale [/16, /8, /4]).  ``dtype`` is the
convolutions' compute dtype; ``remat`` recomputes each DCN encoder layer
in the backward (its BN running statistics move once, ``layers.remat``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.resize import resize_bilinear, resize_nearest_torch
from . import initializers as init
from .attention import MSDAFFN, SpikeMHA
from .dcn import DCNv3
from .layers import (BatchNorm, ConvBN, SepConv, Spike, conv2d, conv_nhwc,
                     fold_t, remat, unfold_t)
from .positional import sine_pe_for_shape


def _bilinear_fpn(dec: nn.Module, feats, y: torch.Tensor, t: int):
    """The top-down FPN of ``dec`` from the /16 map ``y`` [(T*B), h, w, C]
    over ``feats`` -> (mask_feature, the /16, /8, /4 maps)."""
    outs = [unfold_t(y, t)]
    for idx, i in enumerate(range(dec.num_inputs - 2, -1, -1)):
        lf = getattr(dec, f"lateral_spike_{idx}")(fold_t(feats[i])[0])
        cur = getattr(dec, f"lateral_{idx}")(lf)
        y = cur + resize_bilinear(y, tuple(cur.shape[1:3]))
        y = getattr(dec, f"output_spike_{idx}")(y)
        y = conv_nhwc(getattr(dec, f"output_conv_{idx}"), y)
        y = getattr(dec, f"output_bn_{idx}")(y)
        outs.append(unfold_t(y, t))
    mask_feature = conv_nhwc(dec.mask_feature, dec.mask_spike(y))
    return unfold_t(mask_feature, t), outs[:3]


def _add_bilinear_fpn(dec: nn.Module, in_channels: Sequence[int], c: int,
                      out_channels: int, dtype) -> None:
    """The FPN's submodules, under the flax names, on ``dec``."""
    dec.num_inputs = len(in_channels)
    for idx, i in enumerate(range(dec.num_inputs - 2, -1, -1)):
        setattr(dec, f"lateral_spike_{idx}", Spike())
        setattr(dec, f"output_spike_{idx}", Spike())
        setattr(dec, f"lateral_{idx}",
                ConvBN(in_channels[i], c, 1, bias=True, dtype=dtype))
        setattr(dec, f"output_conv_{idx}",
                conv2d(c, c, 3, pad=1, groups=c, dtype=dtype))
        setattr(dec, f"output_bn_{idx}", BatchNorm(c))
    dec.mask_spike = Spike()
    dec.mask_feature = conv2d(c, out_channels, 1, bias=True, dtype=dtype)


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
        # flax's constant(layer_scale) (JAX pixel_decoder.py:43-46)
        self.init_laws = {name: init.constant(layer_scale)
                          for name in ("gamma1", "gamma2", "gamma3")}
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
        self.num_encoder_layers = num_encoder_layers
        self.remat = remat
        self.in_spike, self.out_spike = Spike(), Spike()
        self.encoder_in_proj = ConvBN(in_channels[-1], c, 1, bias=True, **dt)
        for i in range(num_encoder_layers):
            setattr(self, f"encoder_{i}", DCNEncoderLayer(
                c, feedforward_channels, group, dw_kernel_size,
                compat=compat, **dt))
        self.encoder_out_proj = ConvBN(c, c, 1, bias=True, **dt)
        _add_bilinear_fpn(self, in_channels, c, out_channels, dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        t = feats[-1].shape[0]
        xf = self.encoder_in_proj(self.in_spike(fold_t(feats[-1])[0]))
        x = unfold_t(xf, t)
        for i in range(self.num_encoder_layers):
            layer = getattr(self, f"encoder_{i}")
            x = remat(layer, x) if self.remat else layer(x)
        memory = self.out_spike(x)
        y = self.encoder_out_proj(fold_t(memory)[0])
        mask_feature, outs = _bilinear_fpn(self, feats, y, t)
        return mask_feature, memory, outs


class TransformerEncoderPixelDecoder(nn.Module):
    """Pixel decoder with a global spiking-MHA transformer encoder on the
    /16 level (pixel_decoder.py:141-313): ``num_encoder_layers`` x
    (softmax-free spiking MHA with the sine PE on its queries and keys,
    then MSDA_FFN, each a plain residual), then the bilinear top-down
    spiking FPN."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 360),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_encoder_layers: int = 6, num_heads: int = 8,
                 feedforward_channels: int = 1024, dtype=torch.float32):
        super().__init__()
        c = feat_channels
        self.feat_channels = c
        self.num_encoder_layers = num_encoder_layers
        self.in_spike = Spike()
        self.encoder_in_proj = ConvBN(in_channels[-1], c, 1, bias=True,
                                      dtype=dtype)
        for i in range(num_encoder_layers):
            setattr(self, f"encoder_attn_{i}",
                    SpikeMHA(c, num_heads, dtype=dtype))
            setattr(self, f"encoder_ffn_{i}",
                    MSDAFFN(c, feedforward_channels, dtype=dtype))
        self.encoder_out_proj = ConvBN(c, c, 1, bias=True, dtype=dtype)
        _add_bilinear_fpn(self, in_channels, c, out_channels, dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Inside ``parallel.spatial_sharding()`` ``feats`` and the outputs
        are this rank's row bands: the encoder's queries are the band's
        /16 tokens with the band's rows of the PE, and each attends to
        every band's keys and values (``SpikeMHA``'s ``token_bands``)."""
        t, b, h, w, _ = feats[-1].shape
        c = self.feat_channels
        xf = self.encoder_in_proj(self.in_spike(fold_t(feats[-1])[0]))
        tokens = unfold_t(xf, t).reshape(t, b, h * w, c)
        pe = sine_pe_for_shape(h, w, c // 2, tokens.device).reshape(h * w, c)
        pe = pe.expand(b, h * w, c)
        for i in range(self.num_encoder_layers):
            tokens = tokens + getattr(self, f"encoder_attn_{i}")(
                tokens + pe, tokens + pe, tokens, token_bands=True)
            tokens = tokens + getattr(self, f"encoder_ffn_{i}")(tokens)
        memory = tokens.reshape(t, b, h, w, c)
        y = self.encoder_out_proj(fold_t(memory)[0])
        mask_feature, outs = _bilinear_fpn(self, feats, y, t)
        return mask_feature, memory, outs


class FPNPixelDecoder(nn.Module):
    """Plain spiking-FPN pixel decoder (pixel_decoder.py:23-138): a spiked
    3x3 conv + BN on the /16 level, per higher-resolution level a spiked
    lateral 1x1 conv + BN plus the nearest-upsampled coarser map, spiked
    into a 3x3 conv + BN, then a spiked 1x1 mask head with a 1 px zero
    padding (as the JAX module pads it: the mask features come out 2 px
    larger each way).  ``memory`` is the /16 input itself.

    Inside ``parallel.spatial_sharding()`` ``feats`` and the outputs are
    this rank's row bands.  The mask head's padding rows lie above the
    map's first row and below its last, so the first band's mask
    features have one row more at its top and the last band's one more
    at its bottom (on two ranks both bands have ``h + 1`` rows; on more,
    the middle bands ``h``): joined in rank order they are the whole
    map's ``H + 2`` rows."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 360),
                 feat_channels: int = 256, out_channels: int = 256,
                 dtype=torch.float32):
        super().__init__()
        c = feat_channels
        self.num_inputs = len(in_channels)
        self.last_spike = Spike()
        self.last_feat_conv = ConvBN(in_channels[-1], c, 3, pad=1,
                                     bias=True, dtype=dtype)
        for idx, i in enumerate(range(self.num_inputs - 2, -1, -1)):
            setattr(self, f"lateral_spike_{idx}", Spike())
            setattr(self, f"output_spike_{idx}", Spike())
            setattr(self, f"lateral_{idx}",
                    ConvBN(in_channels[i], c, 1, bias=True, dtype=dtype))
            setattr(self, f"output_{idx}",
                    ConvBN(c, c, 3, pad=1, bias=True, dtype=dtype))
        self.mask_spike = Spike()
        self.mask_feature = conv2d(c, out_channels, 1, pad=1, bias=True,
                                   dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        t = feats[-1].shape[0]
        y = self.last_feat_conv(self.last_spike(fold_t(feats[-1])[0]))
        outs = []
        for idx, i in enumerate(range(self.num_inputs - 2, -1, -1)):
            lf = getattr(self, f"lateral_spike_{idx}")(fold_t(feats[i])[0])
            cur = getattr(self, f"lateral_{idx}")(lf)
            y = cur + resize_nearest_torch(y, tuple(cur.shape[1:3]))
            y = getattr(self, f"output_{idx}")(
                getattr(self, f"output_spike_{idx}")(y))
            outs.append(unfold_t(y, t))
        mask_feature = conv_nhwc(self.mask_feature, self.mask_spike(y))
        return unfold_t(mask_feature, t), feats[-1], outs[:3]
