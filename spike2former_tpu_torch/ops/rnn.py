"""Spiking recurrent layers, LSTM, GRU and vanilla (port of
``spike2former_tpu/ops/rnn.py``; reference Qtrick_architecture/
clock_driven/rnn.py :496-881).

Each runs a Python loop over the leading T axis of ``x_seq`` [T, B,
input_size]; autograd through it is BPTT.  The input projection of every
step is one dense layer over the whole sequence (``linear_ih``); the
recurrent one is ``h @ hh_kernel + hh_bias`` with the JAX module's
parameter layout ([H, G*H], not ``nn.LSTM``'s).  The gates keep JAX's
fused order: LSTM i, f, g, o (i, f, o spiked by ``surrogate1``, g by
``surrogate2``, ``c = c f + i g``, ``h = c o``); GRU r, z, n (``n =
sg2(x_n + r h_n)``, ``h = (1 - z) n + z h``).  Surrogates are
``ops/neuron.py``'s, Erf by default as upstream.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..models import initializers as init
from ..models.layers import Linear
from .neuron import SURROGATES


def _sg(surrogate: str | Callable) -> Callable:
    return SURROGATES[surrogate] if isinstance(surrogate, str) else surrogate


def spiking_lstm_cell(gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                      surrogate1="erf", surrogate2=None):
    """One LSTM step from the pre-activations ``gates`` [..., 4H] (input
    and recurrent projections summed).  Returns (h, c)."""
    sg1 = _sg(surrogate1)
    sg2 = sg1 if surrogate2 is None else _sg(surrogate2)
    i, f, g, o = gates.chunk(4, -1)
    i, f, o = sg1(i), sg1(f), sg1(o)
    c = c * f + i * sg2(g)
    return c * o, c


class _SpikingRNN(nn.Module):
    """The parameters of a layer with ``gates`` gate blocks."""

    def __init__(self, input_size: int, hidden_size: int, gates: int,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.linear_ih = Linear(input_size, gates * hidden_size,
                                bias=use_bias, dtype=dtype)
        bound = (1.0 / hidden_size) ** 0.5
        self.hh_kernel = nn.Parameter(
            torch.empty(hidden_size, gates * hidden_size).uniform_(-bound,
                                                                   bound))
        self.hh_bias = (nn.Parameter(torch.zeros(gates * hidden_size))
                        if use_bias else None)
        # flax's lecun_normal over the [H, G*H] kernel, fan_in H, and zeros
        # (JAX ops/rnn.py:60-63, :101-104, :143-146)
        self.init_laws = {"hh_kernel": init.lecun_normal(hidden_size)}
        self.jax_param_order = ("hh_kernel", "hh_bias")
        if use_bias:
            self.init_laws["hh_bias"] = init.zeros

    def hh(self, h: torch.Tensor) -> torch.Tensor:
        y = h @ self.hh_kernel
        return y if self.hh_bias is None else y + self.hh_bias

    def _zeros(self, x_seq: torch.Tensor) -> torch.Tensor:
        return x_seq.new_zeros((x_seq.shape[1], self.hidden_size))


class SpikingLSTM(_SpikingRNN):
    """Multi-step spiking LSTM: ``forward(x_seq, hc=None) -> (hs [T, B,
    H], (h, c))``."""

    def __init__(self, input_size: int, hidden_size: int,
                 use_bias: bool = True, surrogate1: str = "erf",
                 surrogate2: str | None = None, dtype=torch.float32):
        super().__init__(input_size, hidden_size, 4, use_bias, dtype)
        self.surrogate1, self.surrogate2 = surrogate1, surrogate2

    def forward(self, x_seq, hc=None):
        h, c = (self._zeros(x_seq), self._zeros(x_seq)) if hc is None else hc
        x_proj = self.linear_ih(x_seq)
        hs = []
        for xp in x_proj:
            h, c = spiking_lstm_cell(xp + self.hh(h), h, c, self.surrogate1,
                                     self.surrogate2)
            hs.append(h)
        return torch.stack(hs), (h, c)


class SpikingGRU(_SpikingRNN):
    """Multi-step spiking GRU: ``forward(x_seq, h=None) -> (hs, h)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 use_bias: bool = True, surrogate1: str = "erf",
                 surrogate2: str | None = None, dtype=torch.float32):
        super().__init__(input_size, hidden_size, 3, use_bias, dtype)
        self.surrogate1, self.surrogate2 = surrogate1, surrogate2

    def forward(self, x_seq, h=None):
        sg1 = _sg(self.surrogate1)
        sg2 = sg1 if self.surrogate2 is None else _sg(self.surrogate2)
        h = self._zeros(x_seq) if h is None else h
        hs = []
        for xp in self.linear_ih(x_seq):
            x_r, x_z, x_n = xp.chunk(3, -1)
            h_r, h_z, h_n = self.hh(h).chunk(3, -1)
            r, z = sg1(x_r + h_r), sg1(x_z + h_z)
            n = sg2(x_n + r * h_n)
            h = (1.0 - z) * n + z * h
            hs.append(h)
        return torch.stack(hs), h


class SpikingVanillaRNN(_SpikingRNN):
    """Multi-step spiking vanilla RNN, ``h = sg(W_ih x + W_hh h)``:
    ``forward(x_seq, h=None) -> (hs, h)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 use_bias: bool = True, surrogate: str = "erf",
                 dtype=torch.float32):
        super().__init__(input_size, hidden_size, 1, use_bias, dtype)
        self.surrogate = surrogate

    def forward(self, x_seq, h=None):
        sg = _sg(self.surrogate)
        h = self._zeros(x_seq) if h is None else h
        hs = []
        for xp in self.linear_ih(x_seq):
            h = sg(xp + self.hh(h))
            hs.append(h)
        return torch.stack(hs), h
