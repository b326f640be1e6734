"""DCNv3 sampling in the grouped layout (port of the sampler family K3-K7
of ``spike2former_tpu/ops/pallas/dcnv3_kernel.py``).

In that layout ``feat`` is ``[N, G, H_in, W_in*Cg]`` (c fastest) and
``py``, ``px`` and ``mask`` are ``[N, G, P, HoWo]`` f32 pixel coordinates
in unpadded half-pixel space; the static arguments are the JAX functions'
``num_points``, ``h_in``, ``w_in``, ``group`` and ``group_channels``.
Every function computes

    out[n, g, c, o] = sum_p mask[n, g, p, o] * bilinear(feat[n, g, :, :, c]; py, px)

with floor-based taps and zero padding outside ``[0, H) x [0, W)``, or its
gradient.  K3, K5 and K6 differ only in the TPU algorithm, so they share
one counterpart with output ``[N, G, Cg, HoWo]`` (``"gchw"``); K4 is the
same function with output ``[N, G, HoWo, Cg]`` (``"ghwc"``); K7 is the
backward.  ``JAX_COUNTERPARTS`` maps each JAX name to its counterpart.

For a CUDA tensor ``dcnv3_sample_grouped`` is a ``torch.autograd.Function``
whose forward launches ``csrc/dcnv3_sample_grouped.cu`` and whose backward
launches ``csrc/dcnv3_sample_grouped_bwd.cu`` through
``dcnv3_sample_grouped_backward``; a failed build or launch raises.  For a
CPU tensor both are the plain versions, layout adapters around
``ops/dcnv3.py``'s plain sampler and its backward, with PyTorch's autograd
of the forward.  Both paths check their arguments alike.  Launches are
counted in ``dcnv3_sample_grouped.launches`` and
``dcnv3_sample_grouped_backward.launches``.  No model path calls this
module; the JAX package's model path uses K1 and K2 only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .dcnv3 import (CHANNELS_PER_GROUP, GROUPED_BWD_SOURCE, GROUPED_SOURCE,
                    _launch, dcnv3_sample_backward_reference,
                    dcnv3_sample_reference)

LAYOUTS = ("gchw", "ghwc")


class Static(NamedTuple):
    """The JAX functions' static arguments."""
    num_points: int
    h_in: int
    w_in: int
    group: int
    group_channels: int


def _check_args(feat: torch.Tensor, py: torch.Tensor,
                others: tuple[tuple[str, torch.Tensor, str], ...],
                s: Static) -> int:
    """Raise on arguments that disagree with the static ones or that the
    kernels do not take; ``others`` are ``(name, tensor, kind)`` with kind
    ``"coords"`` ([N, G, P, HoWo]) or ``"dout"`` ([N, G, Cg, HoWo]).
    Returns HoWo."""
    if s.group_channels not in CHANNELS_PER_GROUP:
        raise ValueError(f"group_channels {s.group_channels}: the kernels "
                         "take 1, 2, 4, 8, 16 or 32")
    want = (s.group, s.h_in, s.w_in * s.group_channels)
    if feat.dim() != 4 or tuple(feat.shape[1:]) != want:
        raise ValueError(f"feat {tuple(feat.shape)} != [N, *{want}]")
    n = feat.shape[0]
    if py.dim() != 4 or tuple(py.shape[:3]) != (n, s.group, s.num_points):
        raise ValueError(f"py {tuple(py.shape)} != "
                         f"[{n}, {s.group}, {s.num_points}, HoWo]")
    howo = py.shape[3]
    shapes = {"coords": tuple(py.shape),
              "dout": (n, s.group, s.group_channels, howo)}
    for name, t, kind in others:
        if tuple(t.shape) != shapes[kind]:
            raise ValueError(f"{name} {tuple(t.shape)} != {shapes[kind]}")
    for name, t in (("feat", feat), ("py", py)) + tuple(
            (name, t) for name, t, _ in others):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != feat.device:
            raise ValueError(f"{name} is on {t.device}, feat on "
                             f"{feat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return howo


def _value(feat: torch.Tensor, cg: int) -> torch.Tensor:
    """[N, G, H, W*Cg] -> [N, H, W, G*Cg]"""
    n, g, h, wc = feat.shape
    return feat.reshape(n, g, h, wc // cg, cg).permute(0, 2, 3, 1, 4) \
        .reshape(n, h, wc // cg, g * cg)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """[N, G, P, HoWo] -> [N, HoWo, G, P]"""
    return t.permute(0, 3, 1, 2)


def dcnv3_sample_grouped_reference(feat, py, px, mask, *, num_points, h_in,
                                   w_in, group, group_channels, out_layout):
    """Plain version of the grouped forward: ``dcnv3_sample_reference`` in
    the grouped layout.  -> [N, G, Cg, HoWo] ("gchw") or [N, G, HoWo, Cg]
    ("ghwc")."""
    n, cg = feat.shape[0], group_channels
    out = dcnv3_sample_reference(_value(feat, cg), _rows(py), _rows(px),
                                 _rows(mask))
    out = out.reshape(n, -1, group, cg)                  # [N, HoWo, G, Cg]
    order = (0, 2, 3, 1) if out_layout == "gchw" else (0, 2, 1, 3)
    return out.permute(order).contiguous()


def dcnv3_sample_grouped_backward_reference(feat, py, px, mask, dout, *,
                                            num_points, h_in, w_in, group,
                                            group_channels):
    """Plain version of the grouped backward: the formulas of
    ``dcnv3_sample_backward_reference`` in the grouped layout.  dout
    [N, G, Cg, HoWo] -> (dfeat [N, G, H_in, W_in*Cg] in ``feat.dtype``,
    dpy, dpx, dmask [N, G, P, HoWo] f32)."""
    n, cg = feat.shape[0], group_channels
    d = dout.permute(0, 3, 1, 2).reshape(n, -1, group * cg)
    dvalue, dpy, dpx, dmask = dcnv3_sample_backward_reference(
        _value(feat, cg), _rows(py), _rows(px), _rows(mask), d)
    dfeat = dvalue.reshape(n, h_in, w_in, group, cg).permute(0, 3, 1, 2, 4) \
        .reshape(feat.shape).to(feat.dtype)
    return (dfeat, *(t.permute(0, 2, 3, 1).contiguous()
                     for t in (dpy, dpx, dmask)))


class _GroupedFunction(torch.autograd.Function):
    """Grouped forward kernel, backward through the backward kernel, on
    CUDA tensors."""

    @staticmethod
    def forward(ctx, sampler, feat, py, px, mask, s, out_layout):
        ctx.save_for_backward(feat, py, px, mask)
        ctx.static, ctx.out_layout = s, out_layout
        return sampler.launch(feat, py, px, mask, s, out_layout)

    @staticmethod
    def backward(ctx, dout):
        if ctx.out_layout == "ghwc":
            dout = dout.transpose(2, 3)
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a contiguous view at an odd offset
            dout = dout.clone()
        grads = dcnv3_sample_grouped_backward(*ctx.saved_tensors, dout,
                                              **ctx.static._asdict())
        return (None, *grads, None, None)


class _GroupedSample:
    """The grouped forward: the CUDA kernel (differentiable through the
    backward kernel) for a CUDA tensor, the plain version for a CPU
    tensor.  ``launches`` counts the kernel's launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, feat: torch.Tensor, py: torch.Tensor,
                 px: torch.Tensor, mask: torch.Tensor, *, num_points: int,
                 h_in: int, w_in: int, group: int, group_channels: int,
                 out_layout: str) -> torch.Tensor:
        s = Static(num_points, h_in, w_in, group, group_channels)
        if out_layout not in LAYOUTS:
            raise ValueError(f"out_layout {out_layout!r} not in {LAYOUTS}")
        _check_args(feat, py, (("px", px, "coords"),
                               ("mask", mask, "coords")), s)
        if not feat.is_cuda:
            return dcnv3_sample_grouped_reference(
                feat, py, px, mask, **s._asdict(), out_layout=out_layout)
        return _GroupedFunction.apply(self, feat, py, px, mask, s,
                                      out_layout)

    def launch(self, feat, py, px, mask, s: Static,
               out_layout: str) -> torch.Tensor:
        """Launch the forward kernel on checked arguments (no autograd)."""
        n, g, cg = feat.shape[0], s.group, s.group_channels
        howo = py.shape[3]
        shape = (n, g, cg, howo) if out_layout == "gchw" else (n, g, howo, cg)
        out = torch.empty(shape, dtype=feat.dtype, device=feat.device)
        _launch(GROUPED_SOURCE, (feat, py, px, mask, out),
                (n, howo, g, s.num_points, s.h_in, s.w_in, cg,
                 int(out_layout == "gchw")))
        self.launches += 1
        return out


class _GroupedSampleBackward:
    """The grouped backward: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  Shapes as
    ``dcnv3_sample_grouped_backward_reference``; ``launches`` counts the
    kernel's launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, feat: torch.Tensor, py: torch.Tensor,
                 px: torch.Tensor, mask: torch.Tensor, dout: torch.Tensor,
                 *, num_points: int, h_in: int, w_in: int, group: int,
                 group_channels: int):
        s = Static(num_points, h_in, w_in, group, group_channels)
        howo = _check_args(feat, py, (("px", px, "coords"),
                                      ("mask", mask, "coords"),
                                      ("dout", dout, "dout")), s)
        if not feat.is_cuda:
            return dcnv3_sample_grouped_backward_reference(
                feat, py, px, mask, dout, **s._asdict())
        # the kernel scatters into dfeat with atomics: zero it first
        dfeat = torch.zeros_like(feat)
        dpy, dpx, dmask = (torch.empty_like(py) for _ in range(3))
        _launch(GROUPED_BWD_SOURCE,
                (feat, py, px, mask, dout, dfeat, dpy, dpx, dmask),
                (feat.shape[0], howo, group, num_points, h_in, w_in,
                 group_channels))
        self.launches += 1
        return dfeat, dpy, dpx, dmask


dcnv3_sample_grouped = _GroupedSample()
dcnv3_sample_grouped_backward = _GroupedSampleBackward()

# Each TPU kernel of the family (dcnv3_kernel.py, wrapper line) and its
# counterpart here.
JAX_COUNTERPARTS = {
    "dcnv3_sample_pallas_t":                               # K3, :125
        functools.partial(dcnv3_sample_grouped, out_layout="gchw"),
    "dcnv3_sample_pallas":                                 # K4, :197
        functools.partial(dcnv3_sample_grouped, out_layout="ghwc"),
    "dcnv3_sample_pallas_t4":                              # K5, :307
        functools.partial(dcnv3_sample_grouped, out_layout="gchw"),
    "dcnv3_sample_pallas_tg":                              # K6, :566
        functools.partial(dcnv3_sample_grouped, out_layout="gchw"),
    "dcnv3_sample_pallas_t_bwd":                           # K7, :954
        dcnv3_sample_grouped_backward,
}
