"""MS-ResNet spiking residual backbones, 18/34/104 (port of
``spike2former_tpu/models/msresnet.py``; reference
mmseg/models/backbones/MSResnet.py).

A 4-level pyramid of strides 4/8/16/32 and channels ``width * (1, 2, 4,
8)`` over ``[T, B, H, W, C]``, each conv on the (T*B) folded batch.  A
block is spike -> 3x3 conv (stride) -> BN -> spike -> 3x3 conv -> BN (its
scale zero at init) plus a shortcut: a strided 1x1 conv + BN in the
18/34 flavour, a VALID average pool then a 1x1 conv + BN in the 104 one,
whose stem is three 3x3 convs and a BN (7x7 conv + BN for 18/34).
``classify=True`` adds the reference's tail: spike, global average pool,
mean over T, dropout (104 only) and the ``fc`` layer.
"""
from __future__ import annotations

import torch
from torch import nn

from . import initializers as init
from .fpn import Dropout
from .layers import (BatchNorm, Linear, Spike, conv2d, conv_nhwc, fold_t,
                     unfold_t)


class ConvBNF(BatchNorm):
    """Conv + BN on folded [(T*B), H, W, C] tensors.  flax's own
    ``nn.BatchNorm`` sits in the JAX module directly as ``BatchNorm_0``,
    whose leaves ``engine/convert.py`` folds into this module: the BN's
    parameters and statistics are this module's own, beside ``Conv_0``.
    ``zero_init`` starts the BN's scale at 0, as the block's second BN
    does.  A strided 1x1 conv (the 18/34 shortcut) runs as a 1x1 conv of
    the strided pixels: the same products, and on the CPU it steers clear
    of oneDNN's backward of a strided 1x1 conv on a channels-last input,
    which corrupts the heap (torch 2.13, seen as crashes of later
    calls)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, zero_init: bool = False,
                 bias: bool = False, dtype=torch.float32):
        super().__init__(cout)
        if zero_init:
            nn.init.zeros_(self.scale)
            # flax's zeros scale_init (JAX msresnet.py:50-53)
            self.init_laws = {"scale": init.zeros}
        self.subsample = stride if kernel == 1 else 1
        self.Conv_0 = conv2d(cin, cout, kernel, stride // self.subsample,
                             (kernel - 1) // 2, bias=bias, dtype=dtype)

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        s = self.subsample
        if s > 1:
            xf = xf[:, ::s, ::s]
        return super().forward(conv_nhwc(self.Conv_0, xf))


def _avg_pool(xf: torch.Tensor, s: int) -> torch.Tensor:
    """flax's ``nn.avg_pool`` over s x s windows at stride s (VALID) of
    [N, H, W, C]: the window's sum taken in ``xf``'s dtype tap by tap in
    row-major order, then divided by s * s, as XLA's ``reduce_window``
    sums without excess precision (at bf16 each addition rounds:
    ``F.avg_pool2d``'s f32 sum, rounded once, is an ulp off on a third of
    the elements)."""
    n, h, w, c = xf.shape
    win = xf[:, :h // s * s, :w // s * s].reshape(n, h // s, s, w // s, s, c)
    out = win[:, :, 0, :, 0]
    for k in range(1, s * s):
        out = out + win[:, :, k // s, :, k % s]
    return out / (s * s)


class SnnBasicBlock(nn.Module):
    """BasicBlock_104 (``avgpool_shortcut``) / BasicBlock_18
    (MSResnet.py:144-181, :240-280) on folded tensors."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 avgpool_shortcut: bool = True, spike: str = "qspike",
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.avgpool = avgpool_shortcut and stride != 1
        self.Spike_0, self.Spike_1 = Spike(spike), Spike(spike)
        self.conv_bn_1 = ConvBNF(cin, features, 3, stride, dtype=dtype)
        self.conv_bn_2 = ConvBNF(features, features, 3, 1, zero_init=True,
                                 dtype=dtype)
        self.shortcut = None
        if stride != 1 or cin != features:
            self.shortcut = ConvBNF(cin, features, 1,
                                    1 if self.avgpool else stride,
                                    dtype=dtype)

    def forward(self, xf: torch.Tensor) -> torch.Tensor:
        y = self.conv_bn_1(self.Spike_0(xf))
        y = self.conv_bn_2(self.Spike_1(y))
        sc = xf
        if self.shortcut is not None:
            if self.avgpool:
                sc = _avg_pool(sc, self.stride)
            sc = self.shortcut(sc)
        return y + sc


# variant -> (blocks per stage, the 104 flavour)
_LAYOUTS = {
    "msresnet18": ([2, 2, 2, 2], False),
    "msresnet34": ([3, 4, 6, 3], False),
    "msresnet104": ([3, 8, 32, 8], True),
}


class MSResNet(nn.Module):
    """4-level spiking ResNet pyramid; ``num_classes > 0`` adds the
    classification tail's ``fc``."""

    def __init__(self, variant: str = "msresnet18", width: int = 64,
                 T: int = 1, num_classes: int = 0, spike: str = "qspike",
                 dtype=torch.float32):
        super().__init__()
        if variant not in _LAYOUTS:
            raise ValueError(f"unknown MS-ResNet variant {variant!r}; "
                             f"the port has {tuple(_LAYOUTS)}")
        self.T, self.dtype = T, dtype
        self.num_block, self.avgpool = _LAYOUTS[variant]
        if self.avgpool:
            for i, (cin, s) in enumerate(((3, 2), (width, 1), (width, 1))):
                setattr(self, f"stem_conv_{i}",
                        conv2d(cin, width, 3, s, 1, bias=True, dtype=dtype))
            self.stem_bn = BatchNorm(width)
        else:
            self.stem = ConvBNF(3, width, 7, 2, dtype=dtype)
        cin = width
        for stage, blocks in enumerate(self.num_block):
            features = width * 2 ** stage
            for b in range(blocks):
                setattr(self, f"stage{stage}_block{b}", SnnBasicBlock(
                    cin, features, stride=2 if b == 0 else 1,
                    avgpool_shortcut=self.avgpool, spike=spike, dtype=dtype))
                cin = features
        if num_classes > 0:
            self.Spike_0 = Spike(spike)
            self.Dropout_0 = (Dropout(0.2, batch_axis=0) if self.avgpool
                              else None)
            self.fc = Linear(cin, num_classes, dtype=dtype)

    def forward(self, images: torch.Tensor, classify: bool = False):
        """images [B, H, W, 3] -> 4 feature maps [T, B, h, w, C], or with
        ``classify`` class logits [B, num_classes]."""
        x = images[None].expand((self.T,) + tuple(images.shape))
        xf, t = fold_t(x.to(self.dtype))
        if self.avgpool:
            for i in range(3):
                xf = conv_nhwc(getattr(self, f"stem_conv_{i}"), xf)
            xf = self.stem_bn(xf)
        else:
            xf = self.stem(xf)
        feats = []
        for stage, blocks in enumerate(self.num_block):
            for b in range(blocks):
                xf = getattr(self, f"stage{stage}_block{b}")(xf)
            feats.append(unfold_t(xf, t))
        if not classify:
            return feats
        y = self.Spike_0(xf).mean((1, 2))
        y = unfold_t(y, t).mean(0)
        if self.Dropout_0 is not None:
            y = self.Dropout_0(y)
        return self.fc(y)
