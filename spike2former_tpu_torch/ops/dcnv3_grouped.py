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

Both kernels stage a group's map in shared memory: a block owns one
(image, group) and a band of its output pixels.  ``grouped_tile_plan``
chooses the tile from the shapes (a plain function, so the CPU tests reach
it).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .dcnv3 import (CHANNELS_PER_GROUP, GROUPED_BWD_SOURCE, GROUPED_SOURCE,
                    NUM_SMS, SHARED_CHANNELS, SMEM_BYTES, _banded, _launch,
                    _pixel_floats, dcnv3_sample_backward_reference,
                    dcnv3_sample_reference)

LAYOUTS = ("gchw", "ghwc")
# shared memory a block of either kernel may stage: two blocks an SM
GROUPED_SMEM_BYTES = SMEM_BYTES // 2


class GroupedPlan(NamedTuple):
    """What one block of the grouped kernels owns and stages: one (image,
    group) and one of ``bands`` bands of its output pixels, with ``rows``
    map rows staged, ``halo`` above the band's own rows and ``halo + 1``
    below (``rows`` 0 stages nothing: every tap reads, and the backward
    adds into, device memory; ``rows`` = H stages the whole map)."""
    bands: int
    rows: int
    halo: int

    def smem_bytes(self, w: int, cg: int, backward: bool) -> int:
        """The staged rows: the forward's padded pixel stride, or the
        backward's channels and the accumulator of its shared ones."""
        return _grouped_pixel_floats(cg, backward) * self.rows * w * 4

    def whole(self, h: int) -> bool:
        """One block owns the group's whole map: the backward then stores
        dfeat itself and needs no zero-filled dfeat."""
        return self.bands == 1 and self.rows >= h


def _grouped_pixel_floats(cg: int, backward: bool) -> int:
    """Shared floats a staged pixel takes (the kernels' smem)."""
    if backward:
        return cg + min(cg, SHARED_CHANNELS)
    return _pixel_floats(1, cg, False)


def _grouped_threads(cg: int, backward: bool) -> int:
    """Threads a block at most (kThreads in the sources)."""
    threads = 256 if backward else 512
    return threads // 2 if cg >= 32 else threads


@functools.cache
def grouped_tile_plan(n: int, h: int, w: int, howo: int, g: int, cg: int,
                      *, backward: bool) -> GroupedPlan:
    """Choose the tile of the grouped forward (``backward`` False) or
    backward for feat [N, G, H, W*Cg] and HoWo output pixels.

    A block takes one output column a thread, so a group's columns go in
    bands of at most ``_grouped_threads``; the forward, with fewer
    (image, group) pairs than SMs, takes more bands, so that every SM
    works.  Each block stages its group's whole map when it fits
    ``GROUPED_SMEM_BYTES`` (the flagship's 32x32 at Cg=8: 48 KB either
    way); a map that does not is staged in bands of rows with halos, more
    bands until the rows fit, then fewer halo rows, then nothing
    (``_banded``, as K1's and K2's ``tile_plan``).  A single band that
    stages the whole map owns it: the backward then stores dfeat without
    atomics or zero-fill.  Plans are kept per shape: the wrappers ask on
    every launch."""
    bands = math.ceil(howo / _grouped_threads(cg, backward))
    if not backward:
        bands = max(bands, NUM_SMS // (n * g))
    bands = max(1, min(h, howo, bands))
    fit = min(h, GROUPED_SMEM_BYTES
              // (_grouped_pixel_floats(cg, backward) * w * 4))
    if fit >= h:
        return GroupedPlan(bands, h, 0)
    return GroupedPlan(*_banded(h, howo, max(bands, min(2, howo)), fit))


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
        plan = grouped_tile_plan(n, s.h_in, s.w_in, howo, g, cg,
                                 backward=False)
        out = torch.empty(shape, dtype=feat.dtype, device=feat.device)
        _launch(GROUPED_SOURCE, (feat, py, px, mask, out),
                (n, howo, g, s.num_points, s.h_in, s.w_in, cg, *plan,
                 int(out_layout == "gchw"), feat.device.index))
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
        n = feat.shape[0]
        plan = grouped_tile_plan(n, h_in, w_in, howo, group, group_channels,
                                 backward=True)
        # a block that owns a group's whole map stores its dfeat; with
        # bands the halos overlap and the kernel adds with atomics
        dfeat = (torch.empty_like(feat) if plan.whole(h_in)
                 else torch.zeros_like(feat))
        dpy, dpx, dmask = (torch.empty_like(py) for _ in range(3))
        _launch(GROUPED_BWD_SOURCE,
                (feat, py, px, mask, dout, dfeat, dpy, dpx, dmask),
                (n, howo, group, num_points, h_in, w_in, group_channels,
                 *plan, feat.device.index))
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
