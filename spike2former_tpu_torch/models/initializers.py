"""flax's initializers as laws a module declares for its parameters.

The JAX package builds its initial variables with flax's ``model.init``:
``nn.Dense`` and ``nn.Conv`` kernels from ``lecun_normal`` (a unit normal
cut at +-2, scaled so that the std is ``1/sqrt(fan_in)``), biases zero,
``BatchNorm`` and ``LayerNorm`` scales one and biases zero, running means
zero and variances one; a module may declare another initializer for a
parameter of its own.  ``engine/weights.py:init_laws`` gives every entry of
a port model's state_dict its ``Law``: these defaults by module type, and
the laws a module lists in its ``init_laws`` dict (names relative to the
module), next to the parameters it owns, which override them.

``Law.sample`` draws what the flax initializer draws from the same key,
in flax's shape (``utils/jax_random.py``): the unit draw of
``jax.random`` times the initializer's float32 factor, computed in float32
as ``jax.nn.initializers`` computes it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..utils import jax_random as jr

# std of a unit normal truncated to (-2, 2) (jax.nn.initializers
# .variance_scaling's constant)
TRUNCATED_STD = 0.87962566103423978


@dataclass(frozen=True)
class Law:
    """``kind`` 'constant' (every element ``scale``), 'normal' (mean 0, std
    ``scale``: ``nn.initializers.normal``), 'truncated_normal' (a unit
    normal cut at +-2 times ``scale``, not renormalised:
    ``nn.initializers.truncated_normal``) or, with ``fan_in``,
    ``variance_scaling(scale, 'fan_in', kind)`` of kind 'truncated_normal'
    or 'uniform' (on (-s, s), s = sqrt(3 scale / fan_in))."""
    kind: str
    scale: float
    fan_in: int = 0

    @property
    def factor(self) -> float:
        """The float32 multiplier of the unit draw, as JAX rounds it:
        ``variance = f32(scale / fan_in)``, then ``sqrt(variance) /
        f32(TRUNCATED_STD)`` or ``sqrt(3 * variance)``."""
        if not self.fan_in:
            return float(np.float32(self.scale))
        variance = np.float32(self.scale / self.fan_in)
        if self.kind == "truncated_normal":
            return float(np.sqrt(variance) / np.float32(TRUNCATED_STD))
        if self.kind == "uniform":
            return float(np.sqrt(np.float32(3) * variance))
        raise ValueError(f"no variance scaling of kind {self.kind!r}")

    @property
    def std(self) -> float:
        """The law's standard deviation."""
        return {"constant": 0.0, "normal": self.factor,
                "truncated_normal": self.factor * TRUNCATED_STD,
                "uniform": self.factor / math.sqrt(3.0)}[self.kind]

    @property
    def bound(self) -> float:
        """The least b with |x| <= b for every draw (inf for a normal)."""
        return {"constant": abs(self.scale), "normal": math.inf,
                "truncated_normal": 2.0 * self.factor,
                "uniform": self.factor}[self.kind]

    def sample(self, key: jr.Key, shape: Sequence[int],
               device=None) -> torch.Tensor:
        """The flax initializer's float32 draw of ``shape`` (flax's shape
        and layout) from ``key``, on ``device``."""
        if self.kind == "constant":
            return torch.full(tuple(shape), self.scale, dtype=torch.float32,
                              device=device)
        if self.kind == "normal":
            unit = jr.normal(key, shape, device=device)
        elif self.kind == "truncated_normal":
            unit = jr.truncated_normal(key, -2.0, 2.0, shape, device=device)
        elif self.kind == "uniform":
            unit = jr.uniform(key, shape, -1.0, 1.0, device=device)
        else:
            raise ValueError(f"unknown law {self.kind!r}")
        return unit * self.factor


def constant(value: float) -> Law:
    return Law("constant", float(value))


zeros, ones = constant(0.0), constant(1.0)


def normal(stddev: float) -> Law:
    """flax's ``nn.initializers.normal(stddev)``."""
    return Law("normal", float(stddev))


def truncated_normal(stddev: float) -> Law:
    """flax's ``nn.initializers.truncated_normal(stddev)``."""
    return Law("truncated_normal", float(stddev))


def lecun_normal(fan_in: int) -> Law:
    """flax's ``lecun_normal()``: ``variance_scaling(1, 'fan_in',
    'truncated_normal')``; flax's fan_in is the product of every kernel
    axis but the output one."""
    return Law("truncated_normal", 1.0, int(fan_in))


def uniform_fan_in(fan_in: int, scale: float = 1.0) -> Law:
    """flax's ``variance_scaling(scale, 'fan_in', 'uniform')``."""
    return Law("uniform", float(scale), int(fan_in))
