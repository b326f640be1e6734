"""Cascade encoder-decoder segmentor (port of
``spike2former_tpu/models/cascade.py``; reference
mmseg/models/segmentors/cascade_encoder_decoder.py:13-140).

``num_stages`` decode heads: stage 0 is an ``FPNHead`` on the FPN
features, and each later stage refines ``(features, previous logits)``.
Training sums each stage's decode loss under a ``decode_<i>.`` prefix,
and prediction takes the last stage.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .fpn import ConvBNT, FPNHead, FPNNeck, Neuron, build_backbone
from .layers import conv2d, conv_nhwc, fold_t, unfold_t


class CascadeRefineHead(nn.Module):
    """A stage >= 1 head: the previous logits embedded by a 1x1 conv
    (``logit_embed``) and added to the finest FPN feature at every T
    step, then neuron -> 3x3 conv + BN -> neuron -> 1x1 ``cls``, averaged
    over T and added to the previous logits as a correction."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 channels: int = 128, neuron: str = "lif",
                 dtype=torch.float32):
        super().__init__()
        self.logit_embed = conv2d(num_classes, in_channels, 1, bias=True,
                                  dtype=dtype)
        self.refine_neuron_0 = Neuron(neuron)
        self.refine_conv_0 = ConvBNT(in_channels, channels, 3, 1, dtype=dtype)
        self.refine_neuron_1 = Neuron(neuron)
        self.cls = conv2d(channels, num_classes, 1, bias=True, dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor],
                prev_logits: torch.Tensor) -> torch.Tensor:
        y = feats[0]
        prev = prev_logits
        if prev.shape[1:3] != y.shape[2:4]:
            prev = resize_bilinear(prev, tuple(y.shape[2:4]))
        y = y + conv_nhwc(self.logit_embed, prev)[None]
        y = self.refine_neuron_1(self.refine_conv_0(self.refine_neuron_0(y)))
        yf, t = fold_t(y)
        delta = unfold_t(conv_nhwc(self.cls, yf), t).mean(0)
        return prev + delta


class CascadeSegmentor(nn.Module):
    """Backbone + FPN neck + ``num_stages`` cascaded decode heads
    (``stage0`` the FPN head, ``stage1``... the refinements)."""

    def __init__(self, num_classes: int = 150, num_stages: int = 2,
                 embed_dim: Sequence[int] = (64, 128, 256, 360),
                 backbone_heads: int = 8, T: int = 4,
                 variant: str = "sdtv2", neck_channels: int = 256,
                 head_channels: int = 128, neuron: str = "lif",
                 depths_stage3: int = 6, depths_stage4: int = 2,
                 dtype=torch.float32):
        super().__init__()
        if num_stages < 2:
            raise ValueError(f"a cascade needs >= 2 stages, got {num_stages}")
        if variant.startswith("msresnet"):
            raise ValueError("the cascade takes a spiking MetaFormer "
                             f"backbone, not {variant!r}")
        self.dtype, self.num_stages = dtype, num_stages
        self.backbone, chans, strides = build_backbone(
            variant, embed_dim, backbone_heads, T, depths_stage3,
            depths_stage4, dtype)
        self.band_stride = strides[-1]
        self.neck = FPNNeck(chans, neck_channels, neuron, dtype)
        self.stage0 = FPNHead(num_classes, neck_channels, head_channels,
                              strides, neuron, dtype=dtype)
        for i in range(1, num_stages):
            setattr(self, f"stage{i}", CascadeRefineHead(
                num_classes, neck_channels, head_channels, neuron, dtype))

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """Each stage's logits at the finest stride, averaged over T:
        the training contract (each stage gets its own decode loss).
        Inside ``parallel.spatial_sharding()`` a row band's, as
        ``FPNSegmentor``'s: each refinement embeds the previous stage's
        band of logits."""
        feats = self.neck(self.backbone(images))
        outs = [self.stage0(feats)]
        for i in range(1, self.num_stages):
            outs.append(getattr(self, f"stage{i}")(feats, outs[-1]))
        return outs

    def predict_logits(self, images: torch.Tensor,
                       valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """The last stage's logits at input resolution; ``valid_hw`` is
        ignored, as in ``FPNSegmentor``."""
        del valid_hw
        return resize_bilinear(self(images)[-1], tuple(images.shape[1:3]))
