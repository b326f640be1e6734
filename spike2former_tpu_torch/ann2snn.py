"""ANN->SNN conversion: rate-coded IF networks from trained ReLU ANNs
(port of ``spike2former_tpu/ann2snn.py``; reference
Qtrick_architecture/clock_driven/ann2snn/converter.py:7-106).

``Converter.calibrate`` runs calibration batches through the ANN and
records each ReLU site's scale ``s``: the maximum of its output (mode
'max') or a quantile ('99.9%', or a float in (0, 1]), combined over the
batches by a running maximum, as VoltageHook does.  ``Converter.convert``
returns the SNN forward in which each ReLU is ``VoltageScaler(1/s) ->
IFNode(v_threshold=1, v_reset=None) -> VoltageScaler(s)``: the input is
repeated over ``t`` steps, the stateless layers run on the folded
``t*B`` batch, each IF site is the port's ``multistep_if`` (soft reset,
sigmoid surrogate), and the output is the mean over the steps.

The ANN is a flat sequence of modules, callables and ``"relu"`` markers
(``AnnSequential``), the scope the reference converts: feedforward nets.
A module at index ``i`` is the submodule ``layers_{i}``, flax's name for
it, so ``engine/convert.py`` carries the JAX module's weights across; an
``nn.Conv2d`` there takes channels-last input, as flax's ``nn.Conv``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn

from .ops.neuron import multistep_if

__all__ = ["AnnSequential", "Converter", "quantile"]


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of all of ``x``'s elements with linear
    interpolation, computed as ``jnp.quantile`` does (position ``q * (n -
    1)`` in float32).  It selects with ``kthvalue``: ``torch.quantile``
    refuses inputs of more than 2**24 elements, which a full-width
    calibration exceeds."""
    flat = x.float().reshape(-1)
    n = flat.numel()
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(
        n - 1, dtype=torch.float32)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    w_hi = pos - lo
    low = flat.kthvalue(min(max(lo, 0), n - 1) + 1).values
    high = flat.kthvalue(min(max(hi, 0), n - 1) + 1).values
    return low * (1.0 - w_hi).to(flat.device) + high * w_hi.to(flat.device)


class AnnSequential(nn.Module):
    """A feedforward ANN of modules, callables and ``"relu"`` markers.

    ``forward(x)``: the ANN; ``forward(x, calibrate=True, percentile=p)``
    returns ``(y, stats)``, each ReLU site's maximum (``p`` None) or ``p``
    quantile; ``forward(x, snn_scales=s, t=T)``: the SNN's output, the
    mean over ``T`` steps."""

    def __init__(self, layers: Sequence):
        super().__init__()
        self.layers = list(layers)
        for i, layer in enumerate(self.layers):
            if isinstance(layer, nn.Module):
                setattr(self, f"layers_{i}", layer)

    @staticmethod
    def _run_layer(layer: Callable, x: torch.Tensor) -> torch.Tensor:
        if isinstance(layer, nn.Conv2d):  # channels-last in and out
            return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return layer(x)

    def forward(self, x, *, calibrate: bool = False,
                percentile: float | None = None,
                snn_scales: Sequence[float] | None = None, t: int = 32):
        snn = snn_scales is not None
        if snn:
            x = x[None].expand((t,) + tuple(x.shape))
        stats, site = [], 0
        for layer in self.layers:
            if layer == "relu":
                if snn:
                    s = float(snn_scales[site])
                    x = multistep_if(x / s, v_threshold=1.0, v_reset=None,
                                     surrogate="sigmoid").spikes * s
                else:
                    x = torch.relu(x)
                    if calibrate:
                        stats.append(x.max() if percentile is None
                                     else quantile(x, percentile))
                site += 1
            elif snn:
                flat = self._run_layer(layer,
                                       x.reshape((-1,) + x.shape[2:]))
                x = flat.reshape((t, -1) + flat.shape[1:])
            else:
                x = self._run_layer(layer, x)
        if snn:
            return x.mean(0)
        return (x, stats) if calibrate else x


@dataclass
class Converter:
    """ANN->SNN converter; ``mode`` 'max', a percent string such as
    '99.9%', or a float in (0, 1] (converter.py:56-80)."""

    mode: str | float = "max"

    def _percentile(self) -> float | None:
        if isinstance(self.mode, str):
            if self.mode.lower() == "max":
                return None
            if self.mode.endswith("%"):
                return float(self.mode[:-1]) / 100.0
            raise ValueError(f"unknown conversion mode {self.mode!r}")
        p = float(self.mode)
        if not 0.0 < p <= 1.0:
            raise ValueError(f"mode float must be in (0, 1], got {p}")
        return p

    @torch.no_grad()
    def calibrate(self, ann: AnnSequential, batches) -> list[float]:
        """Each ReLU site's scale from the calibration ``batches``."""
        pct = self._percentile()
        scales = [0.0] * sum(1 for layer in ann.layers if layer == "relu")
        for x in batches:
            _, stats = ann(x, calibrate=True, percentile=pct)
            for i, v in enumerate(torch.stack(stats).tolist()):
                scales[i] = max(scales[i], v)
        if any(s <= 0.0 for s in scales):
            raise ValueError(
                f"calibration produced non-positive scales {scales}; "
                "use more/representative calibration data")
        return scales

    def convert(self, ann: AnnSequential, batches, t: int = 32):
        """Calibrate and return ``(snn_apply, scales)``;
        ``snn_apply(x, t=...)`` is the rate-decoded SNN."""
        scales = tuple(self.calibrate(ann, batches))

        def snn_apply(x, t: int = t):
            return ann(x, snn_scales=scales, t=t)

        return snn_apply, scales
