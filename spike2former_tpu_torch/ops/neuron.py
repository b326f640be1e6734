"""Stateful multi-step spiking neurons (port of
``spike2former_tpu/ops/neuron.py``).

Each neuron is a loop over the leading T axis that carries the membrane
potential from step to step: charge, fire through a surrogate spike
function, then a soft reset (``v_reset=None``: subtract the threshold) or
a hard one (back to ``v_reset``), with the reset's path to the spike cut
under ``detach_reset``.  Autograd through the loop gives the BPTT
gradients that the JAX package's ``lax.scan`` gives.

The surrogates fire as Heaviside ``v >= 0`` (a potential exactly at
threshold fires) and take their own derivative in the backward
(SpikingJelly's surrogate.py): sigmoid, atan, erf, soft-sign and
piecewise-quadratic.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .spike import quant_ste


def _heaviside(v: torch.Tensor) -> torch.Tensor:
    return (v >= 0.0).to(v.dtype)


def _surrogate(name: str, grad: Callable, default_alpha: float):
    """A Heaviside-forward spike function whose backward is ``grad(alpha,
    v, g)``, as a ``torch.autograd.Function`` and its caller."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v, alpha):
            ctx.save_for_backward(v)
            ctx.alpha = alpha
            return _heaviside(v)

        @staticmethod
        def backward(ctx, g):
            (v,) = ctx.saved_tensors
            return grad(ctx.alpha, v, g), None

    Fn.__name__ = f"{name}_surrogate_fn"

    def surrogate(v: torch.Tensor, alpha: float = default_alpha
                  ) -> torch.Tensor:
        return Fn.apply(v, alpha)

    surrogate.__name__ = f"{name}_surrogate"
    return surrogate


def _sigmoid_grad(alpha, v, g):
    s = torch.sigmoid(alpha * v)
    return g * alpha * s * (1.0 - s)


def _atan_grad(alpha, v, g):
    return g * (alpha / 2.0) / (1.0 + (0.5 * math.pi * alpha * v) ** 2)


def _erf_grad(alpha, v, g):
    return g * torch.exp(-(alpha * v) ** 2) * (alpha / math.sqrt(math.pi))


def _soft_sign_grad(alpha, v, g):
    return g / (2.0 * alpha * (1.0 / alpha + v.abs()) ** 2)


def _piecewise_quadratic_grad(alpha, v, g):
    grad = g * (alpha - alpha * alpha * v.abs())
    return torch.where(v.abs() > 1.0 / alpha, torch.zeros_like(grad), grad)


sigmoid_surrogate = _surrogate("sigmoid", _sigmoid_grad, 4.0)
atan_surrogate = _surrogate("atan", _atan_grad, 2.0)
erf_surrogate = _surrogate("erf", _erf_grad, 2.0)
soft_sign_surrogate = _surrogate("soft_sign", _soft_sign_grad, 2.0)
piecewise_quadratic_surrogate = _surrogate(
    "piecewise_quadratic", _piecewise_quadratic_grad, 1.0)

SURROGATES: dict[str, Callable] = {
    "sigmoid": sigmoid_surrogate,
    "atan": atan_surrogate,
    "erf": erf_surrogate,
    "soft_sign": soft_sign_surrogate,
    "piecewise_quadratic": piecewise_quadratic_surrogate,
}


class NeuronOutput(NamedTuple):
    spikes: torch.Tensor  # [T, ...] spike train
    v: torch.Tensor       # final membrane potential [...]


def _run(x_seq: torch.Tensor, charge: Callable, surrogate, v_threshold,
         v_reset, detach_reset, v_init) -> NeuronOutput:
    sg = SURROGATES[surrogate] if isinstance(surrogate, str) else surrogate
    v = torch.zeros_like(x_seq[0]) if v_init is None else v_init
    spikes = []
    for x in x_seq:
        v = charge(v, x)
        spike = sg(v - v_threshold)
        spike_d = spike.detach() if detach_reset else spike
        if v_reset is None:  # soft reset
            v = v - spike_d * v_threshold
        else:                # hard reset
            v = (1.0 - spike_d) * v + spike_d * v_reset
        spikes.append(spike)
    return NeuronOutput(torch.stack(spikes), v)


def multistep_if(x_seq: torch.Tensor, v_threshold: float = 1.0,
                 v_reset: float | None = 0.0,
                 surrogate: str | Callable = "sigmoid",
                 detach_reset: bool = False,
                 v_init: torch.Tensor | None = None) -> NeuronOutput:
    """Multi-step IF neuron: ``V[t] = V[t-1] + X[t]``, then fire and
    reset (SpikingJelly ``MultiStepIFNode``)."""
    return _run(x_seq, lambda v, x: v + x, surrogate, v_threshold, v_reset,
                detach_reset, v_init)


def multistep_lif(x_seq: torch.Tensor, tau: float = 2.0,
                  v_threshold: float = 1.0, v_reset: float | None = 0.0,
                  surrogate: str | Callable = "sigmoid",
                  detach_reset: bool = False, decay_input: bool = True,
                  v_init: torch.Tensor | None = None) -> NeuronOutput:
    """Multi-step LIF neuron (SpikingJelly ``MultiStepLIFNode``), with
    ``v_rest = v_reset or 0``:
    ``decay_input=True``: ``V[t] = V[t-1] + (X[t] - (V[t-1] - v_rest)) / tau``;
    ``decay_input=False``: ``V[t] = V[t-1] - (V[t-1] - v_rest) / tau + X[t]``."""
    v_rest = 0.0 if v_reset is None else v_reset
    inv_tau = 1.0 / tau
    if decay_input:
        def charge(v, x):
            return v + (x - (v - v_rest)) * inv_tau
    else:
        def charge(v, x):
            return v - (v - v_rest) * inv_tau + x
    return _run(x_seq, charge, surrogate, v_threshold, v_reset,
                detach_reset, v_init)


def multistep_plif(x_seq: torch.Tensor, w: torch.Tensor,
                   v_threshold: float = 1.0, v_reset: float | None = 0.0,
                   surrogate: str | Callable = "sigmoid",
                   detach_reset: bool = False,
                   v_init: torch.Tensor | None = None) -> NeuronOutput:
    """Parametric LIF (SpikingJelly ``MultiStepParametricLIFNode``): the
    LIF with ``1/tau = sigmoid(w)``, ``w`` a learnt scalar."""
    v_rest = 0.0 if v_reset is None else v_reset
    inv_tau = torch.sigmoid(w)
    return _run(x_seq, lambda v, x: v + (x - (v - v_rest)) * inv_tau,
                surrogate, v_threshold, v_reset, detach_reset, v_init)


def multistep_eif(x_seq: torch.Tensor, tau: float = 2.0,
                  delta_t: float = 1.0, theta_rh: float = 0.8,
                  v_threshold: float = 1.0, v_reset: float | None = 0.0,
                  surrogate: str | Callable = "sigmoid",
                  detach_reset: bool = False,
                  v_init: torch.Tensor | None = None) -> NeuronOutput:
    """Exponential integrate-and-fire (SpikingJelly ``MultiStepEIFNode``):
    ``V[t] = V[t-1] + (X[t] + v_rest - V[t-1]
    + delta_t * exp((V[t-1] - theta_rh) / delta_t)) / tau``."""
    v_rest = 0.0 if v_reset is None else v_reset
    inv_tau = 1.0 / tau

    def charge(v, x):
        return v + (x + v_rest - v
                    + delta_t * torch.exp((v - theta_rh) / delta_t)) * inv_tau

    return _run(x_seq, charge, surrogate, v_threshold, v_reset,
                detach_reset, v_init)


def multistep_qif(x_seq: torch.Tensor, v_init: torch.Tensor | None = None
                  ) -> NeuronOutput:
    """Multi-step Q_IFNode: IF charge, ``Quant(0..8)`` fire, soft reset by
    the fired levels, spikes ``/ 8``.  From a reset membrane over a whole
    ``[T, ...]`` call it equals ``qspike`` applied elementwise."""
    v = torch.zeros_like(x_seq[0]) if v_init is None else v_init
    spikes = []
    for x in x_seq:
        v = v + x
        spike = quant_ste(v, 8.0)
        v = v - spike
        spikes.append(spike * 0.125)
    return NeuronOutput(torch.stack(spikes), v)
