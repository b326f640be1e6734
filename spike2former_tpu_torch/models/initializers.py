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

The law is flax's; the draws are not: ``Law.draw_`` takes a CPU
``torch.Generator``, where flax folds each variable's name into a
threefry key.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# std of a unit normal truncated to (-2, 2) (jax.nn.initializers
# .variance_scaling's constant)
TRUNCATED_STD = 0.87962566103423978


@dataclass(frozen=True)
class Law:
    """``kind`` 'constant' (every element ``scale``), 'normal' (mean 0, std
    ``scale``), 'truncated_normal' (flax's ``truncated_normal(scale)``: a
    unit normal cut at +-2, times ``scale``, not renormalised) or 'uniform'
    (on (-``scale``, ``scale``))."""
    kind: str
    scale: float

    @property
    def std(self) -> float:
        """The law's standard deviation."""
        return {"constant": 0.0, "normal": self.scale,
                "truncated_normal": self.scale * TRUNCATED_STD,
                "uniform": self.scale / math.sqrt(3.0)}[self.kind]

    @property
    def bound(self) -> float:
        """The least b with |x| <= b for every draw (inf for a normal)."""
        return {"constant": abs(self.scale), "normal": math.inf,
                "truncated_normal": 2.0 * self.scale,
                "uniform": self.scale}[self.kind]

    def draw_(self, t: torch.Tensor, gen: torch.Generator) -> None:
        """Fill ``t`` (any device) in place from ``gen``."""
        cpu = torch.empty(t.shape, dtype=t.dtype)
        if self.kind == "constant":
            cpu.fill_(self.scale)
        elif self.kind == "normal":
            cpu.normal_(0.0, self.scale, generator=gen)
        elif self.kind == "truncated_normal":
            torch.nn.init.trunc_normal_(cpu, 0.0, self.scale,
                                        -2.0 * self.scale, 2.0 * self.scale,
                                        generator=gen)
        elif self.kind == "uniform":
            cpu.uniform_(-self.scale, self.scale, generator=gen)
        else:
            raise ValueError(f"unknown law {self.kind!r}")
        with torch.no_grad():
            t.copy_(cpu)


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
    return truncated_normal(1.0 / math.sqrt(fan_in) / TRUNCATED_STD)


def uniform_fan_in(fan_in: int, scale: float = 1.0) -> Law:
    """flax's ``variance_scaling(scale, 'fan_in', 'uniform')``."""
    return Law("uniform", math.sqrt(3.0 * scale / fan_in))
