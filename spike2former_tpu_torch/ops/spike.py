"""Normalized integer spike primitives (port of ``spike2former_tpu/ops/spike.py``).

``quant_ste(x, d, lo)`` is ``round(clamp(x, lo, d))`` with a straight-through
gradient kept on the CLOSED interval ``lo <= x <= d``.  ``torch.round`` rounds
half to even, as ``jnp.round`` does.  ``qspike`` is the Q_IFNode fast path
``round(clamp(x, 0, 8)) / 8`` used throughout the SDTv2 flagship;
``multispike_norm`` (``round(clamp(x, 0, 4)) / 4``) and ``multispike4``
(unnormalized) are SDTv3's, and ``multispike8`` is the MAE flavour's:
``floor(clamp(x, 0, 8) + 0.5) / 8``, rounding half UP, with its gradient
gated to the OPEN interval ``0 < x < 8``.
"""
from __future__ import annotations

import torch


class _QuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, lo):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, d)
        return torch.round(torch.clamp(x, lo, d))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, d = ctx.bounds
        keep = (x >= lo) & (x <= d)
        return torch.where(keep, g, torch.zeros_like(g)), None, None


def quant_ste(x: torch.Tensor, d: float = 8.0, lo: float = 0.0) -> torch.Tensor:
    """``round(clamp(x, lo, d))``; gradient is the identity on ``[lo, d]``
    and zero outside (boundary values pass gradient)."""
    return _QuantSTE.apply(x, d, lo)


def qspike(x: torch.Tensor) -> torch.Tensor:
    """Q_IFNode with the Quant surrogate: values in {0, 1/8, ..., 1}."""
    return quant_ste(x, 8.0) * 0.125


def multispike_norm(x: torch.Tensor) -> torch.Tensor:
    """SDTv3's stateless neuron: values in {0, 1/4, ..., 1}."""
    return quant_ste(x, 4.0) * 0.25


def multispike4(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized 4-level quantization ``round(clamp(x, 0, 4))``."""
    return quant_ste(x, 4.0)


class _MultiSpike8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.floor(torch.clamp(x, 0.0, 8.0) + 0.5) * 0.125

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x > 0.0) & (x < 8.0)
        return torch.where(keep, g, torch.zeros_like(g))


def multispike8(x: torch.Tensor) -> torch.Tensor:
    """sdtv3MAE's ``Multispike``: ``floor(clamp(x, 0, 8) + 0.5) / 8``
    (round half up), gradient on the open interval ``0 < x < 8``."""
    return _MultiSpike8.apply(x)


def spike_rate(y: torch.Tensor, d: float) -> torch.Tensor:
    """The firing rate of a spike site's normalized output ``y`` at level
    ``d``: ``mean(y) * d``, in float32 (tools/cal_firing_num.py:140-160)."""
    return y.float().mean() * d
