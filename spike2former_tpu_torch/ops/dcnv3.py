"""DCNv3 deformable sampling (port of ``spike2former_tpu/ops/dcnv3.py``).

``dcnv3_core`` builds the sampling coordinates exactly as the JAX package
does (padded-space reference points, x-major dilation grid, then a shift to
unpadded half-pixel space) and hands ``(value, py, px, mask)`` to
``dcnv3_sample``.  The sampler takes ``[N, HoWo, G, P]`` coordinates and
returns ``[N, HoWo, G*Cg]``, so the JAX path's layout transposes disappear.

``dcnv3_sample`` is differentiable.  For a CUDA tensor it calls the
operator ``torch.ops.spike2former.dcnv3_sample`` (``dcnv3_sample_op``, a
``torch.library.custom_op``), which launches ``csrc/dcnv3_sample.cu``
(which replaces the TPU kernel ``dcnv3_sample_pallas_t5``) and whose
gradient launches ``csrc/dcnv3_sample_bwd.cu`` (which replaces
``dcnv3_sample_pallas_t5_bwd``) through ``dcnv3_sample_backward``; as an
operator it is what ``torch.export`` records.  For a tensor on the CPU it
is the plain version ``dcnv3_sample_reference``, with PyTorch's autograd
of it.  Launches are counted in
``dcnv3_sample.launches`` (forward) and ``dcnv3_sample_backward.launches``,
and those of the bf16 forms also in ``.bf16_launches``.

Both kernels take float32 or bfloat16 features (``value``, and ``dout`` for
the backward) with float32 coordinates and mask, as the JAX package hands
a bf16 model's features to its Pallas kernels; out and dvalue come back in
the features' dtype, dpy/dpx/dmask in float32, and every sum is float32.

Both kernels stage a tile of the value map in shared memory: a block owns
one image, a few groups and a band of output pixels.  ``tile_plan`` chooses
the tile from the shapes (a plain function, so the CPU tests reach it).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

def _reference_points(h_in, w_in, kernel_h, kernel_w, dilation_h, dilation_w,
                      stride_h, stride_w):
    """Normalized sampling-center grid (dcnv3_func.py:91-119)."""
    h_out = (h_in - (dilation_h * (kernel_h - 1) + 1)) // stride_h + 1
    w_out = (w_in - (dilation_w * (kernel_w - 1) + 1)) // stride_w + 1
    base_y = (dilation_h * (kernel_h - 1)) // 2 + 0.5
    base_x = (dilation_w * (kernel_w - 1)) // 2 + 0.5
    ref_y = (base_y + np.arange(h_out) * stride_h) / h_in
    ref_x = (base_x + np.arange(w_out) * stride_w) / w_in
    ref = np.stack(np.meshgrid(ref_x, ref_y, indexing="xy"), axis=-1)
    return ref.reshape(h_out * w_out, 2), h_out, w_out


def _dilation_grid(h_in, w_in, kernel_h, kernel_w, dilation_h, dilation_w):
    """Per-point offsets (dcnv3_func.py:122-144) in x-major point order
    (p = kx * kernel_h + ky)."""
    xs = -((dilation_w * (kernel_w - 1)) // 2) + np.arange(kernel_w) * dilation_w
    ys = -((dilation_h * (kernel_h - 1)) // 2) + np.arange(kernel_h) * dilation_h
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx / w_in, gy / h_in], axis=-1).reshape(-1, 2)


def _floor_taps(py: torch.Tensor, px: torch.Tensor, h: int, w: int,
                cg: int):
    """The four floor-based bilinear taps of [N, HoWo, G, P] coordinates:
    yields ``(wy, wx, dwy/dpy, dwx/dpx, in_map, idx)`` where ``idx``
    [N, HoWo*G*P, Cg] indexes a ``[N, H*W*G, Cg]`` view of the value map
    (clamped into the map; ``in_map`` says which taps count)."""
    n, _, g, _ = py.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    gidx = torch.arange(g, device=py.device).view(1, 1, g, 1)
    for dy, wy, sy in ((0, 1.0 - fy, -1.0), (1, fy, 1.0)):
        for dx, wx, sx in ((0, 1.0 - fx, -1.0), (1, fx, 1.0)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            flat = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            idx = (flat * g + gidx).reshape(n, -1, 1).expand(-1, -1, cg)
            yield wy, wx, sy, sx, ok, idx


def dcnv3_sample_reference(value: torch.Tensor, py: torch.Tensor,
                           px: torch.Tensor, mask: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version of the sampler: an explicit floor/frac four-tap gather
    with validity masks, zero padding outside the map, f32 accumulation.

    value [N, H, W, G*Cg]; py/px/mask [N, HoWo, G, P] (pixel coordinates in
    unpadded half-pixel space) -> [N, HoWo, G*Cg] in ``value.dtype``: a
    bf16 value is summed in f32 and rounded once, at the end.
    """
    n, h, w, c = value.shape
    _, howo, g, p = py.shape
    cg = c // g
    feat = value.float().reshape(n, h * w * g, cg)
    out = value.new_zeros((n, howo, g, cg), dtype=torch.float32)
    for wy, wx, _, _, ok, idx in _floor_taps(py, px, h, w, cg):
        wt = torch.where(ok, mask * wy * wx, 0.0)    # [N, HoWo, G, P]
        # taps[n, o, g, p, :] = value[n, tap pixel, g, :]
        taps = torch.gather(feat, 1, idx).reshape(n, howo, g, p, cg)
        out += (wt[..., None] * taps).sum(3)
    return out.reshape(n, howo, c).to(value.dtype)


def dcnv3_sample_backward_reference(value: torch.Tensor, py: torch.Tensor,
                                    px: torch.Tensor, mask: torch.Tensor,
                                    dout: torch.Tensor):
    """Plain version of the sampler's backward, written out: for each of
    the four floor-based taps inside the map, with ``s = <F_tap, dout>``,

      dvalue[tap] += m * wy * wx * dout      dmask += wy * wx * s
      dpy += m * (dwy/dpy) * wx * s          dpx += m * wy * (dwx/dpx) * s

    where ``dwy/dpy`` is -1 on the floor row and +1 on the next (likewise
    x): the floor-based subgradient, also at exact integer coordinates.
    Taps off the map give 0 to every term.

    value [N, H, W, G*Cg]; py/px/mask [N, HoWo, G, P]; dout [N, HoWo, G*Cg]
    -> (dvalue [N, H, W, G*Cg] in ``value.dtype``, summed in f32 and
    rounded once; dpy, dpx, dmask [N, HoWo, G, P] in f32).
    """
    n, h, w, c = value.shape
    _, howo, g, p = py.shape
    cg = c // g
    feat = value.float().reshape(n, h * w * g, cg)
    d = dout.float().reshape(n, howo, g, 1, cg)
    dvalue = torch.zeros_like(feat)
    dpy, dpx, dmask = (torch.zeros_like(py, dtype=torch.float32)
                       for _ in range(3))
    for wy, wx, sy, sx, ok, idx in _floor_taps(py, px, h, w, cg):
        taps = torch.gather(feat, 1, idx).reshape(n, howo, g, p, cg)
        s = torch.where(ok, (taps * d).sum(-1), 0.0)
        dmask += wy * wx * s
        dpy += mask * sy * wx * s
        dpx += mask * wy * sx * s
        wt = torch.where(ok, mask * wy * wx, 0.0)
        dvalue.scatter_add_(1, idx, (wt[..., None] * d).reshape(n, -1, cg))
    return dvalue.reshape(n, h, w, c).to(value.dtype), dpy, dpx, dmask


# Shared-memory tiles of the two kernels (see the notes in their sources).
SMEM_BYTES = 227 * 1024     # the most dynamic shared memory an H100 block
                            # may use
FWD_SMEM_BYTES = SMEM_BYTES        # K1: one block an SM
BWD_SMEM_BYTES = SMEM_BYTES // 2   # K2: two blocks an SM
HALO_ROWS = 3               # rows staged above a band (one more below)
FWD_WARPS, BWD_WARPS = 16, 8   # warps a block, half at Cg = 32 (kThreads)
NUM_SMS = 132               # an H100's SMs
SHARED_CHANNELS = 4         # K2: channels of a staged tap added in shared
                            # memory (kShared in its source)


class TilePlan(NamedTuple):
    """What one block of K1 or K2 owns and stages.  ``rows`` 0 stages
    nothing (every tap reads device memory and K2 adds straight into
    dvalue); ``rows`` = H stages the whole map; ``bands`` 0 (K1 only, with
    ``rows`` = H) runs resident blocks that walk the items."""
    groups: int    # adjacent groups per block
    bands: int     # bands of output pixels per (image, group chunk)
    rows: int      # map rows staged per block
    halo: int      # rows staged above a band's rows (halo + 1 below)

    def smem_bytes(self, w: int, cg: int, p: int, backward: bool) -> int:
        """The staged value rows (and K2's accumulator of its shared
        channels) plus each warp's buffer of 32 items' coordinates and
        mask."""
        return (_pixel_floats(self.groups, cg, backward) * self.rows * w
                + _coord_floats(cg, p, backward)) * 4

    def whole(self, h: int) -> bool:
        """One block owns each group's whole map: K2 then writes dvalue
        with plain stores and needs no zero-filled dvalue."""
        return self.bands == 1 and self.rows >= h


def _pixel_floats(groups: int, cg: int, backward: bool) -> int:
    """Shared floats a staged pixel takes: K1's value tile pads the pixel
    stride to an odd number of 16-byte quads (tile_stride in its source);
    K2's keeps the groups' channels and an accumulator of the first
    ``SHARED_CHANNELS`` of each."""
    if backward:
        return groups * (cg + min(cg, SHARED_CHANNELS))
    return groups * cg + (0 if groups * cg % 8 else 4)


def _warps(cg: int, backward: bool) -> int:
    """Warps a block of K1 or K2 (kThreads / 32 in the sources)."""
    warps = BWD_WARPS if backward else FWD_WARPS
    return warps // 2 if cg >= 32 else warps


def _coord_floats(cg: int, p: int, backward: bool) -> int:
    """The warps' buffers of 32 items' coordinates and mask."""
    return _warps(cg, backward) * 3 * 32 * p


def _band_rows(h: int, howo: int, bands: int, halo: int) -> int:
    """Map rows a band's taps are expected to hit: the rows of its output
    pixels (output pixel o sits on row o*H // HoWo), ``halo`` above and
    ``halo + 1`` below (the floor tap's next row)."""
    ob = -(-howo // bands)
    return min(h, (ob - 1) * h // howo + 3 + 2 * halo)


@functools.cache
def tile_plan(n: int, h: int, w: int, howo: int, g: int, cg: int, p: int,
              *, backward: bool) -> TilePlan:
    """Choose the tile of K1 (``backward`` False) or K2 for value
    [N, H, W, G*Cg] and HoWo output pixels.

    Each block stages the whole map of its groups when it fits the
    kernel's budget (``FWD_SMEM_BYTES``, ``BWD_SMEM_BYTES``) beside the
    warps' coordinate buffers (48 KB a group at the flagship's 32x32,
    Cg=8, with K1's padded pixel stride; for K2 32 KB plus 16 KB of
    accumulator).  K2 then takes one group and HoWo / 256 output pixels a
    block (one item, an output pixel of a group, a thread).  K1, with as
    many (image, group) pairs as SMs or more, takes two groups a block in
    resident blocks (``bands`` 0, the kernel sizes the grid: the
    flagship's train shape); with fewer, one group and one block an SM, in
    bands of output pixels (the serve shape: 4 bands).

    A map that does not fit is staged in bands of rows with halos, more
    bands until the rows fit; bands too narrow for the budget first lose
    halo rows, then stage nothing.  A single band that stages the whole
    map owns it: K2 then stores dvalue without atomics or zero-fill.
    Plans are kept per shape: the wrappers ask on every launch.  They
    hold for both feature dtypes: the bf16 kernels convert the value tile
    to f32 while staging it, so a staged channel takes 4 bytes either way
    (the ``* 4`` of ``smem_bytes``)."""
    budget = BWD_SMEM_BYTES if backward else FWD_SMEM_BYTES
    groups = 2 if (not backward and n * g >= NUM_SMS and g % 2 == 0
                   and TilePlan(2, 0, h, 0).smem_bytes(w, cg, p, False)
                   <= budget) else 1
    fit = min(h, max(0, budget - _coord_floats(cg, p, backward) * 4)
              // (_pixel_floats(groups, cg, backward) * w * 4))
    if fit >= h:
        if backward:
            bands = math.ceil(howo * groups / (_warps(cg, True) * 32))
        elif n * g >= NUM_SMS:
            return TilePlan(groups, 0, h, 0)
        else:
            bands = NUM_SMS * groups // (n * g)
        return TilePlan(groups, max(1, min(h, howo, bands)), h, 0)
    # one item a thread, at least two bands
    bands = max(1, min(2, howo), min(h, howo, math.ceil(
        howo * groups / (_warps(cg, backward) * 32))))
    return TilePlan(groups, *_banded(h, howo, bands, fit))


def _banded(h: int, howo: int, bands: int, fit: int) -> tuple[int, int,
                                                               int]:
    """``(bands, rows, halo)`` for a map of which at most ``fit`` rows fit
    a block: from ``bands`` bands and ``HALO_ROWS`` of halo, more bands
    (up to one a map row or output pixel) until a band's rows
    (``_band_rows``) fit, then fewer halo rows, then nothing staged."""
    halo = HALO_ROWS
    while True:
        rows = _band_rows(h, howo, bands, halo)
        if rows <= fit:
            return bands, rows, halo
        if bands < min(h, howo):
            bands = min(h, howo, 2 * bands)
        elif halo:
            halo -= 1
        else:
            return bands, 0, 0


SOURCE = "dcnv3_sample.cu"
BWD_SOURCE = "dcnv3_sample_bwd.cu"
# the grouped-layout sampler and its backward (ops/dcnv3_grouped.py)
GROUPED_SOURCE = "dcnv3_sample_grouped.cu"
GROUPED_BWD_SOURCE = "dcnv3_sample_grouped_bwd.cu"
CHANNELS_PER_GROUP = (1, 2, 4, 8, 16, 32)
# each library's entry points by the features' dtype: (name, tensor
# pointers, ints); the ints are (n, howo, groups, points, h, w, cg), then
# the tile plan (K1's and K2's TilePlan; the grouped pair's GroupedPlan,
# and the grouped forward's layout flag) and the device index; the stream
# comes last.  K2's bf16 entry takes an f32 accumulator beside dvalue.
_ENTRY = {
    (SOURCE, torch.float32): ("dcnv3_sample_f32", 5, 12),
    (SOURCE, torch.bfloat16): ("dcnv3_sample_bf16", 5, 12),
    (BWD_SOURCE, torch.float32): ("dcnv3_sample_bwd_f32", 9, 12),
    (BWD_SOURCE, torch.bfloat16): ("dcnv3_sample_bwd_bf16", 10, 12),
    (GROUPED_SOURCE, torch.float32): ("dcnv3_sample_grouped_f32", 5, 12),
    (GROUPED_BWD_SOURCE, torch.float32): ("dcnv3_sample_grouped_bwd_f32", 9,
                                          11)}
SOURCES = tuple(dict.fromkeys(src for src, _ in _ENTRY))


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    from .cuda_build import load

    lib = load(source)
    for (src, _), (name, n_ptrs, n_ints) in _ENTRY.items():
        if src == source:
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def build_kernels() -> None:
    """Build (or find) and load the four CUDA libraries (K1, K2 and the
    grouped-layout pair), the ``nvcc`` runs side by side."""
    from .cuda_build import build_all

    build_all(SOURCES)
    for source in SOURCES:
        _library(source)


def _launch(source: str, tensors, ints) -> None:
    """Call ``source``'s entry point for the first tensor's dtype on
    PyTorch's current stream with the tensors' pointers and ``ints``;
    raise if the launch fails."""
    dev = tensors[0].device
    name = _ENTRY[source, tensors[0].dtype][0]
    with torch.cuda.device(dev):
        err = getattr(_library(source), name)(
            *(t.data_ptr() for t in tensors), *ints,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


FEATURE_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_args(value: torch.Tensor, py: torch.Tensor,
                       *others: tuple[str, torch.Tensor]) -> tuple:
    """Raise on what the kernels do not take: ``value`` (and a ``dout``
    among ``others``) float32 or bfloat16, the coordinates and mask
    float32; returns ``(n, h, w, c, howo, g, p)``."""
    n, h, w, c = value.shape
    if py.dim() != 4 or py.shape[0] != n:
        raise ValueError(f"coordinates {tuple(py.shape)} do not match "
                         f"value {tuple(value.shape)}")
    _, howo, g, p = py.shape
    for name, t in others[:2]:
        if t.shape != py.shape:
            raise ValueError(
                f"{name} {tuple(t.shape)} != py {tuple(py.shape)}")
    if c % g or (c // g) not in CHANNELS_PER_GROUP:
        raise ValueError(f"channels {c} over {g} groups: the kernels "
                         "take 1, 2, 4, 8, 16 or 32 channels a group")
    if value.dtype not in FEATURE_DTYPES:
        raise TypeError(f"value must be float32 or bfloat16, got "
                        f"{value.dtype}")
    for name, t in (("value", value), ("py", py)) + others:
        want = value.dtype if name in ("value", "dout") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} with a {value.dtype} "
                            f"value, got {t.dtype}")
        if t.device != value.device:
            raise ValueError(
                f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return n, h, w, c, howo, g, p


@torch.library.custom_op("spike2former::dcnv3_sample", mutates_args=(),
                         device_types="cuda")
def dcnv3_sample_op(value: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """K1 as a PyTorch operator (``torch.ops.spike2former.dcnv3_sample``)
    on CUDA tensors: the ctypes launch is opaque to ``torch.export`` and
    ``torch.compile``, so they see this operator, whose fake form gives
    the output's shape, and an exported program holds one call of it
    per DCN layer.  Its gradient is K2's (``dcnv3_sample_backward``):
    ``value``'s in ``value.dtype``, the coordinates' and mask's in
    float32."""
    return _K1.launch(value, py, px, mask)


@dcnv3_sample_op.register_fake
def _(value, py, px, mask):
    return value.new_empty((value.shape[0], py.shape[1], value.shape[3]))


def _op_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _op_backward(ctx, dout):
    # read once: under torch.utils.checkpoint a saved tensor unpacks once
    saved = ctx.saved_tensors
    dout = dout.to(saved[0].dtype).contiguous()
    if dout.data_ptr() % 16:  # a contiguous view at an odd offset
        dout = dout.clone()
    return tuple(dcnv3_sample_backward(*saved, dout))


dcnv3_sample_op.register_autograd(_op_backward,
                                  setup_context=_op_setup_context)


class _DCNv3Sample:
    """Deformable bilinear sample: K1 through ``dcnv3_sample_op``
    (differentiable through K2) for a CUDA tensor, the plain version for
    a CPU tensor.  Shapes as ``dcnv3_sample_reference``.

    ``launches`` counts the forward kernel's launches (a plain int, on the
    wrapper object so that it survives the name being rebound, as a test
    that wraps the sampler does), ``bf16_launches`` those of its bf16
    form among them."""

    def __init__(self):
        self.launches = 0
        self.bf16_launches = 0

    def __call__(self, value: torch.Tensor, py: torch.Tensor,
                 px: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not value.is_cuda:
            return dcnv3_sample_reference(value, py, px, mask)
        return dcnv3_sample_op(value, py, px, mask)

    def launch(self, value: torch.Tensor, py: torch.Tensor,
               px: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Launch the forward kernel (no autograd) with ``tile_plan``'s
        tile."""
        n, h, w, c, howo, g, p = _check_kernel_args(
            value, py, ("px", px), ("mask", mask))
        plan = tile_plan(n, h, w, howo, g, c // g, p, backward=False)
        out = torch.empty((n, howo, c), dtype=value.dtype,
                          device=value.device)
        _launch(SOURCE, (value, py, px, mask, out),
                (n, howo, g, p, h, w, c // g, *plan, value.device.index))
        self.launches += 1
        self.bf16_launches += value.dtype == torch.bfloat16
        return out


class _DCNv3SampleBackward:
    """Gradients of the sampler: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Shapes as
    ``dcnv3_sample_backward_reference``; ``launches`` counts the kernel's
    launches, ``bf16_launches`` those of its bf16 form among them."""

    def __init__(self):
        self.launches = 0
        self.bf16_launches = 0

    def __call__(self, value: torch.Tensor, py: torch.Tensor,
                 px: torch.Tensor, mask: torch.Tensor, dout: torch.Tensor):
        if not value.is_cuda:
            return dcnv3_sample_backward_reference(value, py, px, mask, dout)
        n, h, w, c, howo, g, p = _check_kernel_args(
            value, py, ("px", px), ("mask", mask), ("dout", dout))
        if dout.shape != (n, howo, c):
            raise ValueError(f"dout {tuple(dout.shape)} != "
                             f"{(n, howo, c)}")
        plan = tile_plan(n, h, w, howo, g, c // g, p, backward=True)
        # a block that owns a group's whole map stores its dvalue; with
        # bands the halos overlap and the kernel adds with atomics.  The
        # bf16 form adds into an f32 buffer (no bf16 atomics) that its
        # second pass rounds into dvalue.
        acc = (torch.empty if plan.whole(h) else torch.zeros)(
            value.shape, dtype=torch.float32, device=value.device)
        dpy, dpx, dmask = (torch.empty_like(py) for _ in range(3))
        if value.dtype == torch.bfloat16:
            dvalue = torch.empty_like(value)
            bufs = (acc, dvalue)
        else:
            dvalue = acc
            bufs = (dvalue,)
        _launch(BWD_SOURCE, (value, py, px, mask, dout, *bufs, dpy, dpx,
                             dmask),
                (n, howo, g, p, h, w, c // g, *plan, value.device.index))
        self.launches += 1
        self.bf16_launches += value.dtype == torch.bfloat16
        return dvalue, dpy, dpx, dmask


# ``_K1`` is the wrapper that ``dcnv3_sample_op`` launches through,
# whatever ``dcnv3_sample`` is rebound to
dcnv3_sample = _K1 = _DCNv3Sample()
dcnv3_sample_backward = _DCNv3SampleBackward()


def dcnv3_core(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, *,
               kernel_h: int = 3, kernel_w: int = 3, stride_h: int = 1,
               stride_w: int = 1, pad_h: int = 1, pad_w: int = 1,
               dilation_h: int = 1, dilation_w: int = 1, group: int = 32,
               group_channels: int = 8, offset_scale: float = 1.0
               ) -> torch.Tensor:
    """Deformable group sampling, equivalent to ``dcnv3_core_pytorch``.

    x [N, H, W, G*Cg]; offset [N, Ho, Wo, G*P*2] per-point (x, y) offsets;
    mask [N, Ho, Wo, G*P] (spiked, not softmaxed) -> [N, Ho, Wo, G*Cg].
    """
    n, h, w, _ = x.shape
    p = kernel_h * kernel_w
    # Coordinates live in padded space as in the reference, then shift to
    # the unpadded map: a tap on the pad ring samples zero either way.
    h_pad, w_pad = h + 2 * pad_h, w + 2 * pad_w
    ref, h_out, w_out = _reference_points(
        h_pad, w_pad, kernel_h, kernel_w, dilation_h, dilation_w,
        stride_h, stride_w)
    grid = _dilation_grid(h_pad, w_pad, kernel_h, kernel_w, dilation_h,
                          dilation_w)
    base = torch.as_tensor(
        (ref[:, None, :] + grid[None, :, :] * offset_scale).astype(np.float32),
        device=x.device)                        # [HoWo, P, 2] (x, y)
    hw_out = h_out * w_out
    offset = offset.reshape(n, hw_out, group, p, 2).float()
    norm = torch.tensor([w_pad, h_pad], dtype=torch.float32, device=x.device)
    loc = base[None, :, None] + offset * (offset_scale / norm)
    # grid_sample(align_corners=False) half-pixel convention, shifted from
    # padded to unpadded pixel space
    px = (loc[..., 0] * w_pad - 0.5 - pad_w).contiguous()
    py = (loc[..., 1] * h_pad - 0.5 - pad_h).contiguous()
    m = mask.reshape(n, hw_out, group, p).float().contiguous()
    out = dcnv3_sample(x.contiguous(), py, px, m)
    return out.reshape(n, h_out, w_out, group * group_channels)
