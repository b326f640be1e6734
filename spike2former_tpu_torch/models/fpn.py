"""The FPN model family (port of ``spike2former_tpu/models/fpn.py``):
a spiking backbone, the FPN_SNN neck and the FPNHead_SNN per-pixel head
(reference: mmseg/models/necks/fpn.py:372, decode_heads/fpn_head.py:140,
configs/FPN/*).

Every conv of the neck and head takes its input through a ``Neuron``: a
multi-step LIF (IF, EIF, parametric LIF) over the T axis with
``tau=2.0`` and ``detach_reset=True``, or the stateless multispike
quantizer.  The backbone runs all T steps (no collapse) and trains its
BN (no ``norm_eval``), as the JAX package builds it.  Layout is
channels-last ``[T, B, H, W, C]``; submodules carry the flax names.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from ..ops.neuron import (multistep_eif, multistep_if, multistep_lif,
                          multistep_plif)
from ..ops.resize import resize_bilinear, resize_nearest_torch
from ..parallel.mesh import global_block
from ..utils import jax_random as jr
from . import initializers as init
from .layers import ConvBN, Spike, conv2d, conv_nhwc, fold_t, unfold_t
from .sdtv2 import SpikingMetaFormer

NEURONS = ("lif", "if", "eif", "plif")


class Neuron(nn.Module):
    """Temporal neuron over [T, B, ...]: ``kind`` 'lif', 'if', 'eif' (binary
    spikes, hard reset) or 'plif' (learnt ``w``, ``1/tau = sigmoid(w)``,
    0 at init); any other kind is the stateless ``multispike_norm``
    quantizer, a ``Spike`` site named ``Spike_0`` as in flax."""

    def __init__(self, kind: str = "lif"):
        super().__init__()
        self.kind = kind
        if kind == "plif":
            self.w = nn.Parameter(torch.zeros(()))
            # flax's constant(0.0) (JAX fpn.py:49)
            self.init_laws = {"w": init.zeros}
        elif kind not in NEURONS:
            self.Spike_0 = Spike("multispike_norm")

    def extra_repr(self) -> str:
        return self.kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "lif":
            return multistep_lif(x, tau=2.0, detach_reset=True).spikes
        if self.kind == "if":
            return multistep_if(x, detach_reset=True).spikes
        if self.kind == "eif":
            return multistep_eif(x, tau=2.0, detach_reset=True).spikes
        if self.kind == "plif":
            return multistep_plif(x, self.w, detach_reset=True).spikes
        return self.Spike_0(x)


class ConvBNT(ConvBN):
    """Conv (no bias, ``padding`` each side) + BN with T folded into the
    batch: [T, B, H, W, Cin] -> [T, B, H, W, Cout]."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 padding: int = 0, dtype=torch.float32):
        super().__init__(cin, cout, kernel, pad=padding, dtype=dtype)

    def forward(self, x):
        xf, t = fold_t(x)
        return unfold_t(super().forward(xf), t)


def _resize_t(y: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [T, B, H, W, C] to ``hw``."""
    yf, t = fold_t(y)
    return unfold_t(resize_bilinear(yf, hw), t)


class FPNNeck(nn.Module):
    """FPN_SNN (fpn.py:372): neuron -> lateral 1x1 conv + BN per level, a
    nearest-neighbour top-down sum, then neuron -> 3x3 conv + BN."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256, 360),
                 out_channels: int = 256, neuron: str = "lif",
                 dtype=torch.float32):
        super().__init__()
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"lateral_neuron_{i}", Neuron(neuron))
            setattr(self, f"lateral_{i}",
                    ConvBNT(c, out_channels, 1, dtype=dtype))
            setattr(self, f"fpn_neuron_{i}", Neuron(neuron))
            setattr(self, f"fpn_{i}",
                    ConvBNT(out_channels, out_channels, 3, 1, dtype=dtype))

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        lat = [getattr(self, f"lateral_{i}")(
            getattr(self, f"lateral_neuron_{i}")(f))
            for i, f in enumerate(feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + resize_nearest_torch(
                lat[i], tuple(lat[i - 1].shape[2:4]))
        return [getattr(self, f"fpn_{i}")(
            getattr(self, f"fpn_neuron_{i}")(y)) for i, y in enumerate(lat)]


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` in training mode: each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``.  The keep
    mask is ``jax.random.bernoulli(key, 1 - rate, x.shape)`` of ``key``,
    which the train step sets to flax's key of this module
    (``dropout_key``); ``draw``, when set instead, hands in the uniforms
    to keep by (``draw(shape, device)``, kept below ``1 - rate``).
    ``batch_axis`` is the input's batch axis, along which a data-parallel
    step's ranks take their blocks of the global mask (1 for the heads'
    ``[T, B, ...]`` features).  Training without either is an error."""

    def __init__(self, rate: float, batch_axis: int = 1):
        super().__init__()
        self.rate, self.batch_axis = rate, batch_axis
        self.key: jr.Key | None = None
        self.draw: Callable | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if self.draw is not None:
            keep = self.draw(tuple(x.shape), x.device) < keep_prob
        elif self.key is not None:
            full, start, stop = global_block(x.shape, self.batch_axis)
            keep = jr.bernoulli(self.key, keep_prob, full,
                                axis=self.batch_axis, start=start,
                                stop=stop, device=x.device)
        else:
            raise RuntimeError("Dropout in training mode needs a key (the "
                               "train step sets it) or a draw")
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def dropout_key(step_rng: jr.Key, path: str) -> jr.Key:
    """flax's key of the ``nn.Dropout`` at module path ``path`` (the port's
    module names are flax's) in a step applied with ``rngs={'dropout':
    step_rng}``: its scope's first ``make_rng('dropout')``."""
    return jr.fold_in_static(step_rng, tuple(path.split(".")) + (1,))


class FPNHead(nn.Module):
    """FPNHead_SNN (fpn_head.py:140-240): per level a scale head of
    ``max(1, log2(stride / strides[0]))`` (neuron -> 3x3 conv + BN [-> x2
    bilinear upsample]) stages, summed at the finest stride; then neuron
    -> dropout -> 1x1 classifier, logits averaged over T:
    [B, h, w, num_classes]."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 channels: int = 128,
                 feature_strides: Sequence[int] = (4, 8, 16, 32),
                 neuron: str = "lif", dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        s0 = feature_strides[0]
        self.lengths = [max(1, int(math.log2(s) - math.log2(s0)))
                        for s in feature_strides]
        self.upsample = [s != s0 for s in feature_strides]
        for i, n in enumerate(self.lengths):
            for k in range(n):
                setattr(self, f"head_neuron_{i}_{k}", Neuron(neuron))
                setattr(self, f"head_conv_{i}_{k}",
                        ConvBNT(in_channels if k == 0 else channels,
                                channels, 3, 1, dtype=dtype))
        self.decode_neuron = Neuron(neuron)
        self.Dropout_0 = Dropout(dropout) if dropout > 0 else None
        self.Conv_0 = conv2d(channels, num_classes, 1, bias=True,
                             dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        out = None
        for i, n in enumerate(self.lengths):
            y = feats[i]
            for k in range(n):
                y = getattr(self, f"head_neuron_{i}_{k}")(y)
                y = getattr(self, f"head_conv_{i}_{k}")(y)
                if self.upsample[i]:
                    y = _resize_t(y, (y.shape[2] * 2, y.shape[3] * 2))
            if out is None:
                out = y
            else:
                if y.shape[2:4] != out.shape[2:4]:
                    y = _resize_t(y, tuple(out.shape[2:4]))
                out = out + y
        out = self.decode_neuron(out)
        if self.Dropout_0 is not None:
            out = self.Dropout_0(out)
        xf, t = fold_t(out)
        return unfold_t(conv_nhwc(self.Conv_0, xf), t).mean(0)


def build_backbone(variant: str, embed_dim: Sequence[int],
                   backbone_heads: int, T: int, depths_stage3: int,
                   depths_stage4: int, dtype
                   ) -> tuple[nn.Module, tuple[int, ...], tuple[int, ...]]:
    """The FPN family's backbone for ``variant`` with its levels'
    channels and strides: an MS-ResNet (``msresnet18/34/104``, width
    ``embed_dim[0]``, strides 4/8/16/32) or the spiking MetaFormer of
    ``variant`` over all T steps, its BN trained (strides 2/4/8/16)."""
    e = tuple(embed_dim)
    if variant.startswith("msresnet"):
        from .msresnet import MSResNet

        return (MSResNet(variant=variant, width=e[0], T=T, dtype=dtype),
                tuple(e[0] * 2 ** i for i in range(4)), (4, 8, 16, 32))
    backbone = SpikingMetaFormer(
        e, num_heads=backbone_heads, T=T, depths_stage3=depths_stage3,
        depths_stage4=depths_stage4, dtype=dtype, variant=variant)
    last = e[2] if variant == "sdtv3mae" else e[3]
    return backbone, (e[0] // 2, e[0], e[1], last), (2, 4, 8, 16)


class FPNSegmentor(nn.Module):
    """Backbone + FPN neck + per-pixel head (configs/FPN/*)."""

    def __init__(self, num_classes: int = 150,
                 embed_dim: Sequence[int] = (64, 128, 256, 360),
                 backbone_heads: int = 8, T: int = 4,
                 variant: str = "sdtv2", neck_channels: int = 256,
                 head_channels: int = 128, neuron: str = "lif",
                 depths_stage3: int = 6, depths_stage4: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone, chans, strides = build_backbone(
            variant, embed_dim, backbone_heads, T, depths_stage3,
            depths_stage4, dtype)
        # the coarsest level's stride: the unit of a row band
        self.band_stride = strides[-1]
        self.neck = FPNNeck(chans, neck_channels, neuron, dtype)
        self.head = FPNHead(num_classes, neck_channels, head_channels,
                            strides, neuron, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] normalized -> logits at the finest level's
        stride [B, h, w, num_classes], in training mode with ``train()``.
        Inside ``parallel.spatial_sharding()`` ``images`` is this rank's
        row band (``shard_rows`` at ``band_stride``) and so are the
        logits: the neurons, BNs and the mean over T are elementwise, the
        convolutions take their halos (``conv_nhwc``), the nearest
        top-down is a repetition of the band's rows and the bilinear
        upsamples take one halo row (``ops/resize.py``)."""
        return self.head(self.neck(self.backbone(images)))

    def predict_logits(self, images: torch.Tensor,
                       valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """Logits at input resolution [B, H, W, num_classes].  ``valid_hw``
        is accepted and ignored, as in the JAX package: the network is
        local convolution only, so the padding of a bucketed input only
        gives logits that the post-processing crops away."""
        del valid_hw
        return resize_bilinear(self(images), tuple(images.shape[1:3]))
