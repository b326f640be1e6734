"""Seeded random weights for a port model that has no checkpoint.

Layer-scale gammas and BatchNorm statistics are drawn at O(1), as the
reference's test golden does (``tests/torch_golden.py:randomize_torch``): at
their init values (gammas 1e-6) whole branches, the DCN one among them,
would be numerically silent; so would every MS-ResNet residual branch,
whose second BN starts at a zero scale (each BN scale is drawn around 1).  Conv and linear weights are drawn at
``2/sqrt(fan_in)`` so that the q8 spikes keep firing at any width.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.layers import BatchNorm, BNAndPad


def randomize_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every parameter and BN statistic of ``model`` in place from a
    CPU ``torch.Generator`` seeded with ``seed``; returns ``model``."""
    gen = torch.Generator().manual_seed(seed)

    def draw(t: torch.Tensor, kind: str, a: float, b: float):
        cpu = torch.empty(t.shape, dtype=t.dtype)
        getattr(cpu, kind)(a, b, generator=gen)
        t.copy_(cpu)

    covered = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, BNAndPad)):
                draw(m.mean, "normal_", 0.0, 0.3)
                draw(m.var, "uniform_", 0.5, 2.0)
                draw(m.scale, "normal_", 1.0, 0.2)
                draw(m.bias, "normal_", 0.0, 0.2)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                draw(m.weight, "normal_", 0.0, 2.0 / m.weight[0].numel() ** 0.5)
                if m.bias is not None:
                    draw(m.bias, "normal_", 0.0, 0.5)
            else:
                continue
            covered.update(id(p) for p in m.parameters(recurse=False))
        for p in model.parameters():
            if id(p) not in covered:  # gammas, w, queries, embeddings
                draw(p, "normal_", 0.5, 0.2)
    return model.eval()
