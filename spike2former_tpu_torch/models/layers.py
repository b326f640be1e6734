"""Spiking conv/BN building blocks (port of ``spike2former_tpu/models/layers.py``).

Layout is channels-last ``[T, B, H, W, C]`` (tokens ``[T, B, N, C]``), with T
folded into the batch for every conv/BN, as in the JAX package.  A conv sees
its NHWC input through a ``permute`` view, which PyTorch treats as the
channels-last memory format, so no copy is made around it.

Submodules carry the flax auto-names (``Conv_0``, ``ConvBN_1``,
``BatchNorm_0``, ...) so ``engine/convert.py`` maps the JAX variables onto
this state_dict mechanically.  BatchNorm follows the module's ``training``
flag (``model.train()``) with flax's arithmetic: batch statistics over all
leading axes with the biased variance, and running statistics updated as
``ra = 0.9 * ra + 0.1 * batch`` (the biased variance is stored, unlike
``torch.nn.BatchNorm2d``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.spike import qspike


def fold_t(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """[T, B, ...] -> [(T*B), ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:])), x.shape[0]


def unfold_t(x: torch.Tensor, t: int) -> torch.Tensor:
    return x.reshape((t, -1) + tuple(x.shape[1:]))


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv2d(cin: int, cout: int, k: int = 1, stride: int = 1, pad: int = 0,
           groups: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, groups=groups,
                     bias=bias)


class Spike(nn.Module):
    """Quantized spike site (``qspike``, the only kind on the SDTv2 path)."""

    def forward(self, x):
        return qspike(x)


MOMENTUM = 0.9  # flax convention: ra = m * ra + (1 - m) * batch


def _update_running(ra: torch.Tensor, batch: torch.Tensor) -> None:
    with torch.no_grad():
        ra.copy_(MOMENTUM * ra + (1.0 - MOMENTUM) * batch)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, flax's arithmetic order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  In training mode
    the statistics are the batch's over all leading axes (biased variance)
    and the running statistics move towards them.

    flax computes the variance as ``max(0, E[x^2] - E[x]^2)``; the port
    takes ``torch.var_mean``, the same statistic without the cancellation:
    on a channel that is constant over the batch (a conv of all-zero
    spikes gives its bias) the one-pass form leaves f32 rounding noise of
    order ``bias^2 * 1e-7`` against ``eps = 1e-5``, which moves that
    channel's gradient by up to a percent."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        if self.training:
            var, mean = torch.var_mean(x, tuple(range(x.dim() - 1)),
                                       correction=0)
            _update_running(self.mean, mean)
            _update_running(self.var, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class ConvBN(nn.Module):
    """Conv2d (+ optional bias) then BatchNorm, on [(T*B), H, W, C]."""

    def __init__(self, cin, cout, k=1, stride=1, pad=0, bias=False):
        super().__init__()
        self.Conv_0 = conv2d(cin, cout, k, stride, pad, bias=bias)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return self.BatchNorm_0(conv_nhwc(self.Conv_0, x))


class BNAndPad(nn.Module):
    """BatchNorm, then a 1px border filled with the BN's response to a zero
    input, so a following VALID 3x3 conv sees the halo a padded-then-BN'd
    input would give (sdtv2.py:48-109).  In training mode the statistics are
    the batch's (biased variance, two-pass as the JAX module's ``jnp.var``)
    and the pad value reads the running statistics after their update, with
    the affine parameters detached, as the JAX module does."""

    def __init__(self, c: int, pad_pixels: int = 1, eps: float = 1e-5):
        super().__init__()
        self.p, self.eps = pad_pixels, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        if self.training:
            var, mean = torch.var_mean(x, tuple(range(x.dim() - 1)),
                                       correction=0)
            _update_running(self.mean, mean)
            _update_running(self.var, var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        p = self.p
        pad_value = (self.bias.detach() - self.mean * self.scale.detach()
                     * torch.rsqrt(self.var + self.eps))
        n, h, w, c = y.shape
        out = pad_value.expand(n, h + 2 * p, w + 2 * p, c).clone()
        out[:, p:h + p, p:w + p] = y
        return out


class RepConv(nn.Module):
    """1x1 -> BNAndPad(1) -> dw3x3 VALID -> 1x1 -> BN (sdtv2.py:112-132)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = conv2d(cin, cin, 1)
        self.BNAndPad_0 = BNAndPad(cin)
        self.Conv_1 = conv2d(cin, cin, 3, groups=cin)
        self.Conv_2 = conv2d(cin, cout, 1)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        x = conv_nhwc(self.Conv_0, x)
        x = self.BNAndPad_0(x)
        x = conv_nhwc(self.Conv_1, x)
        x = conv_nhwc(self.Conv_2, x)
        return self.BatchNorm_0(x)


class SepConv(nn.Module):
    """Inverted separable conv with spikes on [T, B, H, W, C].

    ``dw_bn=False, num_spikes=2`` is sdtv2's SepConv;
    ``dw_bn=True, num_spikes=3`` is SepConv_Spike (SNN_core.py:11-63).
    """

    def __init__(self, dim, expansion_ratio=2, kernel_size=7, padding=3,
                 dw_bn=False, num_spikes=2):
        super().__init__()
        med = int(expansion_ratio * dim)
        self.num_spikes = num_spikes
        self.spike = Spike()
        self.ConvBN_0 = ConvBN(dim, med, 1)
        self.Conv_0 = conv2d(med, med, kernel_size, pad=padding, groups=med)
        self.BatchNorm_0 = BatchNorm(med) if dw_bn else None
        self.ConvBN_1 = ConvBN(med, dim, 1)

    def forward(self, x):
        xf, t = fold_t(x)
        xf = self.ConvBN_0(self.spike(xf))
        xf = conv_nhwc(self.Conv_0, self.spike(xf))
        if self.BatchNorm_0 is not None:
            xf = self.BatchNorm_0(xf)
        if self.num_spikes >= 3:
            xf = self.spike(xf)
        return unfold_t(self.ConvBN_1(xf), t)


class MSConvBlock(nn.Module):
    """x += SepConv(x); then spike->3x3(4x)->BN->spike->3x3->BN residual
    (sdtv2.py:183-219)."""

    def __init__(self, dim: int, mlp_ratio: int = 4):
        super().__init__()
        self.spike = Spike()
        self.SepConv_0 = SepConv(dim)
        self.ConvBN_0 = ConvBN(dim, dim * mlp_ratio, 3, pad=1)
        self.ConvBN_1 = ConvBN(dim * mlp_ratio, dim, 3, pad=1)

    def forward(self, x):
        x = x + self.SepConv_0(x)
        xf, t = fold_t(x)
        xf = self.ConvBN_0(self.spike(xf))
        xf = self.ConvBN_1(self.spike(xf))
        return x + unfold_t(xf, t)


class MSMLP(nn.Module):
    """Pointwise spiking MLP over [T, B, H, W, C] (sdtv2.py:222-255)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.spike = Spike()
        self.Conv_0 = conv2d(dim, hidden, 1, bias=True)
        self.BatchNorm_0 = BatchNorm(hidden)
        self.Conv_1 = conv2d(hidden, dim, 1, bias=True)
        self.BatchNorm_1 = BatchNorm(dim)

    def forward(self, x):
        xf, t = fold_t(x)
        xf = self.BatchNorm_0(conv_nhwc(self.Conv_0, self.spike(xf)))
        xf = self.BatchNorm_1(conv_nhwc(self.Conv_1, self.spike(xf)))
        return unfold_t(xf, t)


class DownSampling(nn.Module):
    """(spike->)conv(k, s, p)->BN stage transition (sdtv2.py:386-421)."""

    def __init__(self, cin, cout, kernel=3, stride=2, padding=1,
                 first_layer=False):
        super().__init__()
        self.first_layer = first_layer
        self.spike = Spike()
        self.Conv_0 = conv2d(cin, cout, kernel, stride, padding, bias=True)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        xf, t = fold_t(x)
        if not self.first_layer:
            xf = self.spike(xf)
        xf = self.BatchNorm_0(conv_nhwc(self.Conv_0, xf))
        return unfold_t(xf, t)
