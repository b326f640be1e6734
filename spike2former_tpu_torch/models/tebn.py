"""Temporal BatchNorm variants (port of ``spike2former_tpu/models/tebn.py``):
temporal-effective BN (SpikingJelly layer.py TEBN :1226-1352) and
threshold-dependent BN (TDBN), on ``[T, B, ..., C]`` tensors."""
from __future__ import annotations

import torch
from torch import nn

from . import initializers as init
from .layers import BatchNorm


class TEBN(nn.Module):
    """One BatchNorm over the (T*B) folded batch, then a learnt scale per
    time step (``temporal_scale``, shaped ``(T,) + (1,) * (ndim - 1)`` for
    ``ndim``-dimensional inputs, ones at init)."""

    def __init__(self, T: int, channels: int, ndim: int = 5):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels)
        self.temporal_scale = nn.Parameter(
            torch.ones((T,) + (1,) * (ndim - 1)))
        self.init_laws = {"temporal_scale": init.ones}  # JAX tebn.py:26

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[0]
        y = self.BatchNorm_0(x.reshape((-1,) + tuple(x.shape[2:])))
        return y.reshape(x.shape) * self.temporal_scale[:t]


class TDBN(nn.Module):
    """BatchNorm over the folded batch scaled by ``alpha * v_threshold``,
    so pre-activations land in the neuron's sensitive range."""

    def __init__(self, channels: int, v_threshold: float = 1.0,
                 alpha: float = 1.0):
        super().__init__()
        self.v_threshold, self.alpha = v_threshold, alpha
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(x.reshape((-1,) + tuple(x.shape[2:])))
        return y.reshape(x.shape) * (self.alpha * self.v_threshold)
