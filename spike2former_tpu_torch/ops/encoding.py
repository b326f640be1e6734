"""Spike encoders (port of ``spike2former_tpu/ops/encoding.py``;
SpikingJelly ``clock_driven/encoding.py``): Poisson rate coding, latency
coding and the repeated analog input, each returning ``[T, ...]``."""
from __future__ import annotations

import torch


def poisson_encode(x: torch.Tensor, t: int,
                   generator: torch.Generator | None = None,
                   uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """Rate coding: at each step an element of ``x`` (in [0, 1]) spikes
    where a uniform draw falls below it.  The ``[T, *x.shape]`` uniforms
    come from ``generator`` (on ``x``'s device), or are handed in as
    ``uniforms``.  Float32 0/1 spikes."""
    if uniforms is None:
        uniforms = torch.rand((t,) + tuple(x.shape), generator=generator,
                              device=x.device)
    return (uniforms < x).float()


def latency_encode(x: torch.Tensor, t: int) -> torch.Tensor:
    """Temporal coding: one spike per element, at step ``round((1 -
    clip(x, 0, 1)) * (t - 1))`` (half to even, as ``jnp.round``), so
    stronger inputs spike earlier.  Float32 0/1 spikes."""
    step = torch.round((1.0 - x.clamp(0.0, 1.0)) * (t - 1)).to(torch.int32)
    steps = torch.arange(t, device=x.device).reshape((t,) + (1,) * x.dim())
    return (steps == step[None]).float()


def repeat_encode(x: torch.Tensor, t: int) -> torch.Tensor:
    """Constant-current coding: ``x`` repeated T times (a view), the
    encoding Spike2Former itself uses (sdtv2.py:617)."""
    return x[None].expand((t,) + tuple(x.shape))
