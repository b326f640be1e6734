"""Spike->Conv and Spike->Linear with packed 4-bit activation residuals
(port of ``spike2former_tpu/ops/spike_op.py``).

A spike site emits graded spikes ``k / D`` with ``k`` an integer in
0..D (``ops/spike.py``: D = 8 for ``qspike``), so the exact activation
fits a 4-bit code.  ``spike_conv`` and ``spike_linear`` compute the same
convolution or dense layer as the plain path (input, weight and bias cast
to the compute dtype), but what they keep for the backward is the code,
packed two to a byte (``pack_codes``), and the weight: not the float
activation.  The backward unpacks the code, rebuilds the activation
bit for bit (``k / D`` is exact in every float dtype), with the strides it
had, and computes the gradients as autograd of the plain path does, so
outputs, gradients and parameters after a step are bit-identical with the
switch on or off (``train.packed_residuals``).

The convolution's backward is ``aten::convolution_backward``, the call
autograd makes for ``F.conv2d``: the input gradient is the transposed
convolution, and nothing of the forward is recomputed.  The dense layer's
backward rebuilds the plain path's small graph (the casts and
``F.linear``) on the rebuilt activation and differentiates it, which
recomputes one product of the forward: ``F.linear`` dispatches to
different kernels by the input's rank and layout, and the rebuilt graph
makes the same choice.  The weight is kept on the context, not saved, so
every tensor a packed site saves is ``uint8``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["pack_codes", "unpack_codes", "spike_conv", "spike_linear"]


def pack_codes(k: torch.Tensor) -> torch.Tensor:
    """Pack integer codes (values 0..15) two to a byte: a flat ``uint8``
    tensor of ``ceil(numel / 2)`` bytes, the low nibble from the first
    half of the flat codes and the high nibble from the second half (the
    JAX package's half-split pairing)."""
    flat = k.reshape(-1).to(torch.uint8)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    return flat[:half] | (flat[half:] << 4)


def unpack_codes(packed: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of ``pack_codes`` for a target ``shape`` (``uint8``)."""
    flat = torch.cat([packed & 0xF, packed >> 4])
    return flat[:math.prod(shape)].reshape(shape)


def _encode(ctx, y: torch.Tensor, code_scale: float) -> torch.Tensor:
    """The packed codes of spikes ``y``; ``ctx`` keeps what rebuilds it."""
    ctx.y_meta = (tuple(y.shape), y.stride(), y.dtype, code_scale)
    return pack_codes(torch.round(y.float() * code_scale))


def _decode(ctx, packed: torch.Tensor) -> torch.Tensor:
    """The spikes bit for bit, in their dtype and with their strides."""
    shape, stride, dtype, code_scale = ctx.y_meta
    k = unpack_codes(packed, shape)
    y = torch.empty_strided(shape, stride, dtype=dtype, device=packed.device)
    return y.copy_(k.float() * (1.0 / code_scale))


class _SpikeConv(torch.autograd.Function):
    """NHWC ``y`` -> NHWC conv output in ``dtype``, saving packed codes."""

    @staticmethod
    def forward(ctx, y, weight, bias, dtype, code_scale, stride, padding,
                dilation, groups):
        yd = y.to(dtype)
        w = weight.to(dtype)
        b = None if bias is None else bias.to(dtype)
        out = F.conv2d(yd.permute(0, 3, 1, 2), w, b, stride, padding,
                       dilation, groups)
        ctx.save_for_backward(_encode(ctx, yd, code_scale))
        ctx.weight, ctx.has_bias = weight, bias is not None
        ctx.conv = (stride, padding, dilation, groups)
        ctx.dtypes = (y.dtype, dtype)
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        (packed,) = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conv
        y_dtype, dtype = ctx.dtypes
        yd = _decode(ctx, packed)
        w = ctx.weight.to(dtype)
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        dy, dw, db = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), yd.permute(0, 3, 1, 2), w,
            [w.shape[0]] if ctx.has_bias else None, list(stride),
            list(padding), list(dilation), False, [0] * len(stride), groups,
            mask)
        w32 = ctx.weight.dtype
        return (None if dy is None else dy.permute(0, 2, 3, 1).to(y_dtype),
                None if dw is None else dw.to(w32),
                None if db is None else db.to(w32),
                None, None, None, None, None, None)


def spike_conv(y: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, dtype: torch.dtype,
               code_scale: float = 8.0, *, stride=(1, 1), padding=(0, 0),
               dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` of NHWC spikes ``y`` (values ``k / code_scale``, k in
    0..15) with ``weight`` [O, I/groups, kh, kw] and ``bias`` cast to
    ``dtype``, NHWC out in ``dtype``; the backward keeps packed codes."""
    return _SpikeConv.apply(y, weight, bias, dtype, float(code_scale),
                            tuple(stride), tuple(padding), tuple(dilation),
                            groups)


class _SpikeLinear(torch.autograd.Function):
    """``y`` [..., K] -> [..., M] in ``dtype``, saving packed codes."""

    @staticmethod
    def forward(ctx, y, weight, bias, dtype, code_scale):
        ctx.save_for_backward(_encode(ctx, y, code_scale))
        ctx.weight, ctx.bias, ctx.dtype = weight, bias, dtype
        return F.linear(y.to(dtype), weight.to(dtype),
                        None if bias is None else bias.to(dtype))

    @staticmethod
    def backward(ctx, g):
        (packed,) = ctx.saved_tensors
        ins = [_decode(ctx, packed), ctx.weight, ctx.bias]
        need = [n and t is not None
                for n, t in zip(ctx.needs_input_grad[:3], ins)]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) if t is not None else None
                      for t, n in zip(ins, need)]
            yy, w, b = leaves
            out = F.linear(yy.to(ctx.dtype), w.to(ctx.dtype),
                           None if b is None else b.to(ctx.dtype))
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if n else None for n in need), None, None)


def spike_linear(y: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None, dtype: torch.dtype,
                 code_scale: float = 8.0) -> torch.Tensor:
    """``F.linear`` of spikes ``y`` [..., K] with ``weight`` [M, K] and
    ``bias`` cast to ``dtype``; the backward keeps packed codes."""
    return _SpikeLinear.apply(y, weight, bias, dtype, float(code_scale))
