"""FLOP and parameter counts (port of ``spike2former_tpu/utils/flops.py``;
tools/analysis_tools/get_flops.py's role).

``model_flops`` counts what ``torch.utils.flop_counter.FlopCounterMode``
sees in one call: the matmuls and convolutions (forward and, for a train
step, backward).  The DCNv3 sampler is not among them: on the card it is
a ctypes kernel inside ``torch.ops.spike2former.dcnv3_sample``, which has
no FLOP formula, and its plain version on the CPU is gathers and
elementwise products, which the counter does not count.
``dcn_sampling_flops`` gives the sampler's intrinsic work from the
shapes, to be added once.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

# the sampler's operations, from what K1 and K2 compute:
# forward, per (n, g, point, output pixel): 4 tap weights and their
# products with the mask (16), then per channel 4 multiply-adds (8);
FWD_PER_POINT, FWD_PER_CHANNEL = 16, 8
# backward (K2), per point: the tap weights, their products with the mask
# and their derivatives (16), dmask (4 multiply-adds: 8), dpy and dpx (2 x
# 4 multiply-adds and the scaling by the mask: 20); per channel: the 4
# taps' dot products with dout (8) and dvalue's 4 multiply-adds (8)
BWD_PER_POINT, BWD_PER_CHANNEL = 44, 16


def count_params(model: nn.Module) -> int:
    """The number of parameters (BN statistics are buffers, not counted)."""
    return sum(p.numel() for p in model.parameters())


def model_flops(fn: Callable, *args, **kwargs) -> int:
    """FLOPs of one call ``fn(*args, **kwargs)`` (a forward, or a train
    step with its backward) as ``FlopCounterMode`` counts them."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def dcn_sampling_flops(batch: int, crop_hw: tuple[int, int], *,
                       num_layers: int = 6, group: int = 32,
                       group_channels: int = 8, points: int = 9,
                       stride: int = 16, train: bool = False) -> float:
    """The DCNv3 sampler's intrinsic FLOPs over ``num_layers`` DCN layers
    on the ``crop_hw / stride`` map of ``batch`` images: per layer,
    ``N * HoWo * G * P * (16 + 8 Cg)`` for the forward (K1) and, with
    ``train``, ``N * HoWo * G * P * (44 + 16 Cg)`` more for the backward
    (K2).  The map's size rounds up, as the strided convolutions' do."""
    h = -(-crop_hw[0] // stride)
    w = -(-crop_hw[1] // stride)
    sites = batch * h * w * group * points
    per_layer = sites * (FWD_PER_POINT + FWD_PER_CHANNEL * group_channels)
    if train:
        per_layer += sites * (BWD_PER_POINT + BWD_PER_CHANNEL
                              * group_channels)
    return float(num_layers * per_layer)


# dense peak TFLOP/s by card and compute dtype (NVIDIA's data sheet);
# float32 is without tensor cores: the port's float32 runs with TF32 off
PEAK_TFLOPS = {
    "H100 80GB HBM3": {"bfloat16": 989.4, "float32": 66.9},   # H100 SXM
}


def peak_tflops(device_name: str, dtype: str) -> float:
    """The dense peak of the card named ``device_name``
    (``torch.cuda.get_device_name``) for ``dtype``; raises for a card
    that is not in ``PEAK_TFLOPS``."""
    for key, peaks in PEAK_TFLOPS.items():
        if key in device_name:
            return peaks[dtype]
    raise KeyError(f"no peak known for {device_name!r}: pass --peak-tflops")
