"""Spike encoders (port of ``spike2former_tpu/ops/encoding.py``;
SpikingJelly ``clock_driven/encoding.py``): Poisson rate coding, latency
coding and the repeated analog input, each returning ``[T, ...]``."""
from __future__ import annotations

import torch

from ..utils import jax_random as jr


def poisson_encode(x: torch.Tensor, t: int, key: jr.Key) -> torch.Tensor:
    """Rate coding: at each step an element of ``x`` (in [0, 1]) spikes
    where JAX's ``uniform(key, (t, *x.shape))`` falls below it (JAX
    ``encoding.py:13``).  Float32 0/1 spikes."""
    u = jr.uniform(key, (t,) + tuple(x.shape), device=x.device)
    return (u < x).float()


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
