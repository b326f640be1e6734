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

``feat`` (and ``dout``) may be float32 or bfloat16, the coordinates and
mask are float32, and the outputs come back in ``feat.dtype`` (dpy, dpx,
dmask in float32), as the JAX kernels return them.  At bf16 the JAX
kernels round inside the sum, and each rounding changes the function, so
the bf16 forms round where they do (``_grouped_forward_rounded``): the row
weights ``m * (1 - fy)``, ``m * fy``; the column weights ``1 - fx``,
``fx`` with ``round_columns`` (K3 and K6 cast them to ``expand_ref``'s
dtype; K4 and K5 keep them f32, so at bf16 K5 is K4's function in K3's
layout); and each map column's sum over the points that reach it, before
the f32 sum over the columns and the final rounding.  K7's bf16 form sums
dfeat in f32 and rounds it once, and takes the row weights rounded to bf16
in dpx alone (``dcnv3_sample_backward_reference(round_row_weights=True)``).
In f32 every rounding is the identity, and ``round_columns`` does
nothing.

For a CUDA tensor ``dcnv3_sample_grouped`` is a ``torch.autograd.Function``
whose forward launches ``csrc/dcnv3_sample_grouped.cu`` and whose backward
launches ``csrc/dcnv3_sample_grouped_bwd.cu`` through
``dcnv3_sample_grouped_backward``; a failed build or launch raises.  For a
CPU tensor both are the plain versions, layout adapters around
``ops/dcnv3.py``'s plain sampler and its backward (the bf16 forward its
own, ``_grouped_forward_rounded``), with PyTorch's autograd of the
forward.  Both paths check their arguments alike.  Launches are counted in
``dcnv3_sample_grouped.launches`` and
``dcnv3_sample_grouped_backward.launches``, those of the bf16 forms also in
``.bf16_launches``.  No model path calls this
module; the JAX package's model path uses K1 and K2 only.

Both kernels stage a group's map in shared memory: a block owns one
(image, group) and a band of its output pixels.  ``grouped_tile_plan``
chooses the tile from the shapes and the features' dtype (a plain
function, so the CPU tests reach it): the bf16 forward stages the map as
bf16 and keeps a table of each thread's point terms beside it.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .dcnv3 import (CHANNELS_PER_GROUP, FEATURE_DTYPES, GROUPED_BWD_SOURCE,
                    GROUPED_SOURCE, NUM_SMS, SHARED_CHANNELS, SMEM_BYTES,
                    _banded, _launch, _pixel_floats,
                    dcnv3_sample_backward_reference, dcnv3_sample_reference)

LAYOUTS = ("gchw", "ghwc")
# shared memory a block of either kernel may stage: two blocks an SM
GROUPED_SMEM_BYTES = SMEM_BYTES // 2
# the bf16 forward's point table, bytes a thread: 3 words (y0, the rounded
# row weights, fx) of each of 9 points (kFields, kPoints in the source)
POINT_TABLE_BYTES = 3 * 9 * 4


class GroupedPlan(NamedTuple):
    """What one block of the grouped kernels owns and stages: one (image,
    group) and one of ``bands`` bands of its output pixels, with ``rows``
    map rows staged, ``halo`` above the band's own rows and ``halo + 1``
    below (``rows`` 0 stages nothing: every tap reads, and the backward
    adds into, device memory; ``rows`` = H stages the whole map)."""
    bands: int
    rows: int
    halo: int

    def smem_bytes(self, w: int, cg: int, backward: bool,
                   dtype: torch.dtype = torch.float32) -> int:
        """The staged rows (the forward's padded pixel stride, or the
        backward's channels and the accumulator of its shared ones) and
        the bf16 forward's point table."""
        return (_grouped_pixel_bytes(cg, backward, dtype) * self.rows * w
                + _point_table_bytes(cg, backward, dtype))

    def whole(self, h: int) -> bool:
        """One block owns the group's whole map: the backward then stores
        dfeat itself and needs no zero-filled dfeat."""
        return self.bands == 1 and self.rows >= h


def _grouped_pixel_bytes(cg: int, backward: bool,
                         dtype: torch.dtype = torch.float32) -> int:
    """Shared bytes a staged pixel takes (the kernels' smem): f32 but for
    the bf16 forward, which stages bf16 with the pixel stride padded to an
    odd number of 16-byte quads from Cg = 16 (tile_stride_bf16)."""
    if backward:
        return 4 * (cg + min(cg, SHARED_CHANNELS))
    if dtype == torch.bfloat16:
        return 2 * (cg if cg % 16 else cg + 8)
    return 4 * _pixel_floats(1, cg, False)


def _grouped_threads(cg: int, backward: bool,
                     dtype: torch.dtype = torch.float32) -> int:
    """Threads a block at most (kThreads in the sources): the bf16
    forward's blocks of 256 share an SM three at a time."""
    if not backward and dtype == torch.bfloat16:
        return 256
    threads = 256 if backward else 512
    return threads // 2 if cg >= 32 else threads


def _point_table_bytes(cg: int, backward: bool, dtype: torch.dtype) -> int:
    """The bf16 forward's point table, sized for a block of
    ``_grouped_threads``; none for the other kernels."""
    if backward or dtype != torch.bfloat16:
        return 0
    return POINT_TABLE_BYTES * _grouped_threads(cg, backward, dtype)


@functools.cache
def grouped_tile_plan(n: int, h: int, w: int, howo: int, g: int, cg: int,
                      *, backward: bool, dtype: torch.dtype = torch.float32
                      ) -> GroupedPlan:
    """Choose the tile of the grouped forward (``backward`` False) or
    backward for feat [N, G, H, W*Cg] of ``dtype`` and HoWo output pixels.

    A block takes one output column a thread, so a group's columns go in
    bands of at most ``_grouped_threads``; the forward, with fewer
    (image, group) pairs than SMs, takes more bands, so that every SM
    works: a block an SM for the f32 form, two for the bf16 forms, whose
    blocks of 256 share an SM (at the serve shape 8 bands beat the 6 of
    one block an SM: ``profile_grouped.py``, PERF.md §6).  Each block
    stages its group's whole map when it fits ``GROUPED_SMEM_BYTES`` (the
    flagship's 32x32 at Cg=8: 48 KB either way in f32; the bf16 forward's
    bf16 map 16 KB beside its 27 KB point table);
    a map that does not is staged in bands of rows with halos, more bands
    until the rows fit, then fewer halo rows, then nothing (``_banded``,
    as K1's and K2's ``tile_plan``).  A single band that stages the whole
    map owns it: the backward then stores dfeat without atomics or
    zero-fill.  The backward's plan does not depend on ``dtype``.  Plans
    are kept per shape: the wrappers ask on every launch."""
    bands = math.ceil(howo / _grouped_threads(cg, backward, dtype))
    if not backward:
        per_sm = 2 if dtype == torch.bfloat16 else 1
        bands = max(bands, per_sm * NUM_SMS // (n * g))
    bands = max(1, min(h, howo, bands))
    fit = min(h, (GROUPED_SMEM_BYTES - _point_table_bytes(cg, backward, dtype))
              // (_grouped_pixel_bytes(cg, backward, dtype) * w))
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
    if feat.dtype not in FEATURE_DTYPES:
        raise TypeError(f"feat must be float32 or bfloat16, got "
                        f"{feat.dtype}")
    for name, t in (("feat", feat), ("py", py)) + tuple(
            (name, t) for name, t, _ in others):
        want = feat.dtype if name in ("feat", "dout") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} with a {feat.dtype} "
                            f"feat, got {t.dtype}")
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


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _grouped_forward_rounded(feat, py, px, mask, h, w, cg,
                             round_columns) -> torch.Tensor:
    """The bf16 forms' sum, rounded where the JAX kernels round.  Each
    point p has two tap columns v (slots (p, 0), (p, 1)) and adds the
    contribution ``(F[y0, v] * bf16(m (1 - fy)) + F[y0+1, v] * bf16(m fy))
    * cw`` (cw ``1 - fx`` or ``fx``, rounded to bf16 with
    ``round_columns``) into that column's f32 sum T[v], in point order, as
    the JAX kernels' ``t_acc + g * cexp`` adds it; the output is
    ``sum_v bf16(T[v])`` in f32, rounded once.  Here each slot sums the
    contributions of every slot at its column in slot order, and the
    first slot at a column counts its T.  Taps off the map add nothing; a
    point with a NaN coordinate is dropped (as the CUDA kernels drop it).
    -> [N, G, HoWo, Cg] in ``feat.dtype``."""
    n, g = feat.shape[:2]
    p, howo = py.shape[2:]
    f = feat.float().reshape(n, g, h * w, cg)
    keep = ~(py.isnan() | px.isnan())
    py, px = (torch.where(keep, t, 0.0).permute(0, 1, 3, 2)
              for t in (py, px))                         # [N, G, HoWo, P]
    m = torch.where(keep, mask, 0.0).permute(0, 1, 3, 2)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    rows = ((y0, _round_bf16((1.0 - fy) * m)), (y0 + 1, _round_bf16(fy * m)))
    cols, valid, contrib = [], [], []
    for xx, cw in ((x0, 1.0 - fx), (x0 + 1, fx)):
        if round_columns:
            cw = _round_bf16(cw)
        in_x = keep.permute(0, 1, 3, 2) & (xx >= 0) & (xx <= w - 1)
        g_v = torch.zeros((n, g, howo, p, cg), dtype=torch.float32,
                          device=feat.device)
        for yy, r in rows:
            ok = in_x & (yy >= 0) & (yy <= h - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            tap = torch.gather(f, 2, idx.reshape(n, g, -1, 1).expand(
                -1, -1, -1, cg)).reshape(n, g, howo, p, cg)
            g_v = g_v + torch.where(ok[..., None], tap * r[..., None], 0.0)
        cols.append(xx)
        valid.append(in_x)
        contrib.append(g_v * cw[..., None])
    # slots (p, dx), point-major: [N, G, HoWo, 2P]
    cols, valid = (torch.stack(t, -1).flatten(-2) for t in (cols, valid))
    contrib = torch.stack(contrib, 4).flatten(3, 4)  # [N, G, HoWo, 2P, Cg]
    same = ((cols[..., :, None] == cols[..., None, :])
            & valid[..., :, None] & valid[..., None, :])
    t = torch.zeros_like(contrib)
    for k in range(2 * p):
        t = t + torch.where(same[..., k, None], contrib[..., k, None, :],
                            0.0)
    earlier = torch.ones(2 * p, 2 * p, dtype=torch.bool,
                         device=feat.device).tril(-1)
    first = valid & ~(same & earlier).any(-1)
    return torch.where(first[..., None], _round_bf16(t), 0.0).sum(3) \
        .to(feat.dtype)


def dcnv3_sample_grouped_reference(feat, py, px, mask, *, num_points, h_in,
                                   w_in, group, group_channels, out_layout,
                                   round_columns=False):
    """Plain version of the grouped forward: ``dcnv3_sample_reference`` in
    the grouped layout for f32 features, ``_grouped_forward_rounded`` for
    bf16 ones.  -> [N, G, Cg, HoWo] ("gchw") or [N, G, HoWo, Cg]
    ("ghwc") in ``feat.dtype``."""
    n, cg = feat.shape[0], group_channels
    if feat.dtype == torch.bfloat16:
        out = _grouped_forward_rounded(feat, py, px, mask, h_in, w_in, cg,
                                       round_columns)
        return (out.transpose(2, 3) if out_layout == "gchw"
                else out).contiguous()
    out = dcnv3_sample_reference(_value(feat, cg), _rows(py), _rows(px),
                                 _rows(mask))
    out = out.reshape(n, -1, group, cg)                  # [N, HoWo, G, Cg]
    order = (0, 2, 3, 1) if out_layout == "gchw" else (0, 2, 1, 3)
    return out.permute(order).contiguous()


def dcnv3_sample_grouped_backward_reference(feat, py, px, mask, dout, *,
                                            num_points, h_in, w_in, group,
                                            group_channels):
    """Plain version of the grouped backward: the formulas of
    ``dcnv3_sample_backward_reference`` in the grouped layout, with the
    bf16 dpx's rounded row weights.  dout [N, G, Cg, HoWo] -> (dfeat
    [N, G, H_in, W_in*Cg] in ``feat.dtype``, summed in f32 and rounded
    once; dpy, dpx, dmask [N, G, P, HoWo] f32)."""
    n, cg = feat.shape[0], group_channels
    d = dout.permute(0, 3, 1, 2).reshape(n, -1, group * cg)
    dvalue, dpy, dpx, dmask = dcnv3_sample_backward_reference(
        _value(feat, cg), _rows(py), _rows(px), _rows(mask), d,
        round_row_weights=feat.dtype == torch.bfloat16)
    dfeat = dvalue.reshape(n, h_in, w_in, group, cg).permute(0, 3, 1, 2, 4) \
        .reshape(feat.shape).to(feat.dtype)
    return (dfeat, *(t.permute(0, 2, 3, 1).contiguous()
                     for t in (dpy, dpx, dmask)))


class _GroupedFunction(torch.autograd.Function):
    """Grouped forward kernel, backward through the backward kernel, on
    CUDA tensors."""

    @staticmethod
    def forward(ctx, sampler, feat, py, px, mask, s, out_layout,
                round_columns):
        ctx.save_for_backward(feat, py, px, mask)
        ctx.static, ctx.out_layout = s, out_layout
        return sampler.launch(feat, py, px, mask, s, out_layout,
                              round_columns)

    @staticmethod
    def backward(ctx, dout):
        if ctx.out_layout == "ghwc":
            dout = dout.transpose(2, 3)
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a contiguous view at an odd offset
            dout = dout.clone()
        grads = dcnv3_sample_grouped_backward(*ctx.saved_tensors, dout,
                                              **ctx.static._asdict())
        return (None, *grads, None, None, None)


class _GroupedSample:
    """The grouped forward: the CUDA kernel (differentiable through the
    backward kernel) for a CUDA tensor, the plain version for a CPU
    tensor.  ``round_columns`` (bf16 only) rounds the column weights as K3
    and K6 do.  ``launches`` counts the kernel's launches,
    ``bf16_launches`` those of its bf16 form among them."""

    def __init__(self):
        self.launches = 0
        self.bf16_launches = 0

    def __call__(self, feat: torch.Tensor, py: torch.Tensor,
                 px: torch.Tensor, mask: torch.Tensor, *, num_points: int,
                 h_in: int, w_in: int, group: int, group_channels: int,
                 out_layout: str, round_columns: bool = False
                 ) -> torch.Tensor:
        s = Static(num_points, h_in, w_in, group, group_channels)
        if out_layout not in LAYOUTS:
            raise ValueError(f"out_layout {out_layout!r} not in {LAYOUTS}")
        _check_args(feat, py, (("px", px, "coords"),
                               ("mask", mask, "coords")), s)
        if not feat.is_cuda:
            return dcnv3_sample_grouped_reference(
                feat, py, px, mask, **s._asdict(), out_layout=out_layout,
                round_columns=round_columns)
        return _GroupedFunction.apply(self, feat, py, px, mask, s,
                                      out_layout, round_columns)

    def launch(self, feat, py, px, mask, s: Static, out_layout: str,
               round_columns: bool) -> torch.Tensor:
        """Launch the forward kernel on checked arguments (no autograd)."""
        n, g, cg = feat.shape[0], s.group, s.group_channels
        howo = py.shape[3]
        shape = (n, g, cg, howo) if out_layout == "gchw" else (n, g, howo, cg)
        plan = grouped_tile_plan(n, s.h_in, s.w_in, howo, g, cg,
                                 backward=False, dtype=feat.dtype)
        out = torch.empty(shape, dtype=feat.dtype, device=feat.device)
        bf16 = feat.dtype == torch.bfloat16
        _launch(GROUPED_SOURCE, (feat, py, px, mask, out),
                (n, howo, g, s.num_points, s.h_in, s.w_in, cg, *plan,
                 int(out_layout == "gchw"),
                 *((int(round_columns),) if bf16 else ()),
                 feat.device.index))
        self.launches += 1
        self.bf16_launches += bf16
        return out


class _GroupedSampleBackward:
    """The grouped backward: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  Shapes as
    ``dcnv3_sample_grouped_backward_reference``; ``launches`` counts the
    kernel's launches, ``bf16_launches`` those of its bf16 form among
    them."""

    def __init__(self):
        self.launches = 0
        self.bf16_launches = 0

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
        # bands the halos overlap and the kernel adds with atomics.  The
        # bf16 form adds into an f32 buffer (no bf16 atomics) that its
        # second pass rounds into dfeat.
        acc = (torch.empty if plan.whole(h_in) else torch.zeros)(
            feat.shape, dtype=torch.float32, device=feat.device)
        dpy, dpx, dmask = (torch.empty_like(py) for _ in range(3))
        bf16 = feat.dtype == torch.bfloat16
        if bf16:
            dfeat = torch.empty_like(feat)
            bufs = (acc, dfeat)
        else:
            dfeat = acc
            bufs = (dfeat,)
        _launch(GROUPED_BWD_SOURCE,
                (feat, py, px, mask, dout, *bufs, dpy, dpx, dmask),
                (n, howo, group, num_points, h_in, w_in, group_channels,
                 *plan, feat.device.index))
        self.launches += 1
        self.bf16_launches += bf16
        return dfeat, dpy, dpx, dmask


dcnv3_sample_grouped = _GroupedSample()
dcnv3_sample_grouped_backward = _GroupedSampleBackward()

# Each TPU kernel of the family (dcnv3_kernel.py, wrapper line) and its
# counterpart here.
# ``round_columns`` follows each kernel's bf16 column weights.
JAX_COUNTERPARTS = {
    "dcnv3_sample_pallas_t":                               # K3, :125
        functools.partial(dcnv3_sample_grouped, out_layout="gchw",
                          round_columns=True),
    "dcnv3_sample_pallas":                                 # K4, :197
        functools.partial(dcnv3_sample_grouped, out_layout="ghwc"),
    "dcnv3_sample_pallas_t4":                              # K5, :307
        functools.partial(dcnv3_sample_grouped, out_layout="gchw"),
    "dcnv3_sample_pallas_tg":                              # K6, :566
        functools.partial(dcnv3_sample_grouped, out_layout="gchw",
                          round_columns=True),
    "dcnv3_sample_pallas_t_bwd":                           # K7, :954
        dcnv3_sample_grouped_backward,
}
