"""Lava / Loihi exchange: the weight quantizers, the CUBA neuron mapping
and a lava-dl netx HDF5 writer (port of
``spike2former_tpu/lava_exchange.py``; reference
Qtrick_architecture/clock_driven/lava_exchange.py:62-303).

``step_quantize`` and ``quantize_8bit`` pass the gradient straight
through (a ``torch.autograd.Function``).  The synapse layouts are
torch's own: a ``nn.Linear`` weight [out, in] and a ``nn.Conv2d`` weight
[out, in, kh, kw] are what lava's ``slayer.synapse`` stores, so the
converters check them and hand them on as float32 numpy (the JAX
package's take flax kernels and transpose them to the same arrays).
``export_hdf5`` imports ``h5py`` when it is called, never before.
Loihi's fixed point: 12-bit decays (``decay * 4096``), thresholds as
mantissas at the weight exponent (<< 6).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "step_quantize", "quantize_8bit", "to_cuba_params",
    "linear_to_synapse", "conv_to_synapse", "export_hdf5",
]


class _StepQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step):
        return torch.round(x / step) * step

    @staticmethod
    def backward(ctx, g):
        return g, None


def step_quantize(x: torch.Tensor, step: float = 1.0) -> torch.Tensor:
    """``round(x / step) * step`` (half to even) with a straight-through
    gradient (lava_exchange.py:62-100)."""
    return _StepQuantize.apply(x, step)


def quantize_8bit(x: torch.Tensor, scale: int = 64,
                  descale: bool = False) -> torch.Tensor:
    """lava-dl's pre-synapse weight quantizer (lava_exchange.py:103-107):
    steps of ``2/scale``, clamped to the signed 8-bit range; times
    ``scale`` with ``descale``."""
    q = torch.clamp(step_quantize(x, 2.0 / scale), -256.0 / scale,
                    255.0 / scale)
    return q * scale if descale else q


def to_cuba_params(kind: str, v_threshold: float = 1.0,
                   v_reset: float | None = 0.0, tau: float = 2.0,
                   decay_input: bool = False,
                   scale: int = 1 << 6) -> dict:
    """IF/LIF settings -> lava CUBA neuron parameters
    (``to_lava_neuron_param_dict``, lava_exchange.py:128-155): IF has
    voltage decay 0, LIF ``1/tau``, both current decay 1; lava takes only
    ``v_reset == 0`` (or a soft reset) and no input decay."""
    if v_reset not in (0, 0.0, None):
        raise ValueError("lava only supports v_reset == 0")
    if kind == "if":
        v_decay = 0.0
    elif kind == "lif":
        if decay_input:
            raise ValueError("lava only supports decay_input == False")
        v_decay = 1.0 / tau
    else:
        raise NotImplementedError(f"no CUBA mapping for neuron {kind!r}")
    return {
        "threshold": float(v_threshold),
        "current_decay": 1.0,
        "voltage_decay": float(v_decay),
        "tau_grad": 1, "scale_grad": 1, "scale": scale,
        "shared_param": True, "persistent_state": True,
        "requires_grad": False, "graded_spike": False,
    }


def _numpy(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu()
    return np.asarray(w, np.float32)


def linear_to_synapse(weight, bias=None) -> np.ndarray:
    """A ``nn.Linear`` weight [out, in] as lava's dense synapse weight
    (lava_exchange.py:166-183; lava has no synapse bias)."""
    if bias is not None:
        raise ValueError("lava does not support dense synapse bias")
    w = _numpy(weight)
    if w.ndim != 2:
        raise ValueError(f"expected an [out, in] weight, got {w.shape}")
    return w


def conv_to_synapse(weight, bias=None) -> np.ndarray:
    """A ``nn.Conv2d`` weight [out, in, kh, kw] as lava's conv synapse
    weight (lava_exchange.py:186-210)."""
    if bias is not None:
        raise ValueError("lava does not support conv synapse bias")
    w = _numpy(weight)
    if w.ndim != 4:
        raise ValueError(
            f"expected an [out, in, kh, kw] weight, got {w.shape}")
    return w


def _neuron_group(g, params: dict):
    n = g.create_group("neuron")
    n.create_dataset("iDecay", data=int(params["current_decay"] * 4096))
    n.create_dataset("vDecay", data=int(params["voltage_decay"] * 4096))
    n.create_dataset("vThMant", data=int(round(params["threshold"]
                                               * params["scale"])))
    n.create_dataset("refDelay", data=1)
    n.create_dataset("gradedSpike", data=int(params["graded_spike"]))
    n.create_dataset("type", data=np.bytes_("CUBA"))


def export_hdf5(layers: list[dict], path: str, t_sample: int = 32) -> None:
    """Write a lava-dl netx HDF5 network (``simulation`` and numbered
    ``layer/<i>`` groups).  ``layers``: dicts, each one of
    ``{"type": "input", "shape": (H, W, C) | (F,)}``,
    ``{"type": "dense", "weight": [out, in], "neuron": cuba-dict}`` or
    ``{"type": "conv", "weight": [out, in, kh, kw], "neuron": cuba-dict,
    "stride", "padding", "dilation", "groups": int, "shape": output (H, W,
    C)}``.  Weights are written 8-bit step-quantized (``quantize_8bit``,
    descaled), as lava-dl blocks do (lava_exchange.py:262-267)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("export_hdf5 needs h5py") from e

    with h5py.File(path, "w") as f:
        sim = f.create_group("simulation")
        sim.create_dataset("Ts", data=1)
        sim.create_dataset("tSample", data=int(t_sample))
        lg = f.create_group("layer")
        for i, spec in enumerate(layers):
            g = lg.create_group(str(i))
            kind = spec["type"]
            g.create_dataset("type", data=np.bytes_(kind))
            if kind == "input":
                g.create_dataset("shape",
                                 data=np.asarray(spec["shape"], np.int64))
                continue
            w = _numpy(spec["weight"])
            scale = spec.get("neuron", {}).get("scale", 64)
            wq = quantize_8bit(torch.from_numpy(w), scale,
                               descale=True).numpy()
            g.create_dataset("weight", data=wq)
            _neuron_group(g, spec["neuron"])
            if kind == "dense":
                g.create_dataset("inFeatures", data=w.shape[1])
                g.create_dataset("outFeatures", data=w.shape[0])
                g.create_dataset("shape",
                                 data=np.asarray([w.shape[0]], np.int64))
            elif kind == "conv":
                g.create_dataset("inChannels", data=w.shape[1])
                g.create_dataset("outChannels", data=w.shape[0])
                g.create_dataset("kernelSize",
                                 data=np.asarray(w.shape[2:4], np.int64))
                for key, default in (("stride", 1), ("padding", 0),
                                     ("dilation", 1), ("groups", 1)):
                    g.create_dataset(key, data=int(spec.get(key, default)))
                g.create_dataset("shape",
                                 data=np.asarray(spec["shape"], np.int64))
            else:
                raise NotImplementedError(f"layer type {kind!r}")
