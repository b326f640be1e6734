"""Spiking DCNv3 module (port of ``spike2former_tpu/models/dcn.py``).

SepConv_Spike input/output projections, conv1x1+BN offset and mask heads,
and a Q-IF spike on the sampling mask in place of softmax
(modules/dcnv3.py:213-215).  Layout [T, B, H, W, C].  The sampler takes
the value map in the compute dtype and the offsets and mask in float32
(``ops/dcnv3.py:dcnv3_core``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.dcnv3 import dcnv3_core
from .layers import (BatchNorm, SepConv, Spike, conv2d, conv_nhwc, fold_t,
                     unfold_t)


class DCNv3(nn.Module):
    """3x3 deformable sampling, stride 1, pad 1, offset scale 1 (the
    flagship's, and the JAX module's defaults)."""

    def __init__(self, channels: int = 256, group: int = 32,
                 dw_kernel_size: int = 5, compat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.channels, self.group, self.compat = channels, group, compat
        p = 9  # 3x3 sampling points
        dw_pad = (dw_kernel_size - 1) // 2
        sep_kw = dict(kernel_size=dw_kernel_size, padding=dw_pad,
                      dw_bn=True, num_spikes=3, dtype=dtype)
        spiked = dict(dtype=dtype, spike_input=True)
        self.Spike_0, self.Spike_1, self.Spike_2 = Spike(), Spike(), Spike()
        self.input_proj = SepConv(channels, **sep_kw)
        self.dw_conv = conv2d(channels, channels, dw_kernel_size, pad=dw_pad,
                              groups=channels, **spiked)
        self.dw_bn = BatchNorm(channels)
        self.offset_conv = conv2d(channels, group * p * 2, 1, bias=True,
                                  **spiked)
        self.offset_bn = BatchNorm(group * p * 2)
        self.mask_conv = conv2d(channels, group * p, 1, bias=True, **spiked)
        self.mask_bn = BatchNorm(group * p)
        self.output_proj = SepConv(channels, **sep_kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, _, h, w, _ = x.shape
        value = self.input_proj(x)

        x1f = self.Spike_0(fold_t(x)[0])
        x1f = self.Spike_1(self.dw_bn(conv_nhwc(self.dw_conv, x1f)))
        offset = self.offset_bn(conv_nhwc(self.offset_conv, x1f))
        mask = self.mask_bn(conv_nhwc(self.mask_conv, x1f))
        if self.compat:
            # Reference quirk: the offset/mask heads run channels-first and
            # their outputs are reinterpreted channels-last by a plain
            # reshape, a fixed shuffle that trained weights encode.
            tb = offset.shape[0]
            offset = offset.permute(0, 3, 1, 2).reshape(tb, h, w, -1)
            mask = mask.permute(0, 3, 1, 2).reshape(tb, h, w, -1)
        mask = self.Spike_2(mask)

        out = dcnv3_core(fold_t(value)[0], offset, mask, group=self.group,
                         group_channels=self.channels // self.group)
        return self.output_proj(unfold_t(out, t))
