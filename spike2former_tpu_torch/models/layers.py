"""Spiking conv/BN building blocks (port of ``spike2former_tpu/models/layers.py``).

Layout is channels-last ``[T, B, H, W, C]`` (tokens ``[T, B, N, C]``), with T
folded into the batch for every conv/BN, as in the JAX package.  A conv sees
its NHWC input through a ``permute`` view, which PyTorch treats as the
channels-last memory format, so no copy is made around it.

Submodules carry the flax auto-names (``Conv_0``, ``ConvBN_1``,
``BatchNorm_0``, ...) so ``engine/convert.py`` maps the JAX variables onto
this state_dict mechanically.  BatchNorm follows the module's ``training``
flag (``model.train()``) with flax's arithmetic: batch statistics over all
leading axes with the biased variance, and running statistics updated as
``ra = 0.9 * ra + 0.1 * batch`` (the biased variance is stored, unlike
``torch.nn.BatchNorm2d``).

Mixed precision is flax's: parameters stay float32; each convolution and
dense layer casts its input, weight and bias to its compute ``dtype``
(float32 or bfloat16, flax's ``dtype=``) and returns that dtype, adding
the bias after the product in that dtype as flax does (in float32 the
product takes the bias, as the float32 port always has);
BatchNorm computes its statistics and normalisation in float32 and
returns the dtype of its input.  Everything else follows PyTorch's type
promotion, which is JAX's for these operands (a bf16 activation plus an
f32 parameter is f32).

A convolution or dense layer whose input is a spike output is built with
``spike_input`` set to the spike's kind (``True`` for ``qspike``);
``set_packed_residuals`` switches those sites to ``ops/spike_op.py``,
which saves the spike codes (``y * D``, D the kind's level) packed to 4
bits instead of the activation for the backward (bit-identical
gradients), as the JAX package's ``_packed_cgd`` sites do.

The spike kinds (``SPIKE_FNS``, with the level D of each) are ``qspike``
(SDTv2 and the head, D = 8), ``multispike_norm`` (SDTv3, D = 4) and
``multispike8`` (SDTv3-MAE, round half up, D = 8).

``remat`` (``checkpoint``) recomputes a block in the backward.  The
recomputation must not move BN running statistics a second time (flax's
``nn.remat`` keeps one update): it runs under ``frozen_running_stats``.

Under tensor parallelism (``parallel/tp.py``) a ``Linear`` split by
``shard_params_tp`` is column- or row-parallel over its model group
(``Linear.tp``).  Inside ``parallel.spatial_sharding()`` every activation
is a row band: ``conv_nhwc`` takes the halo rows a kernel taller than one row
reads from the neighbouring bands, and ``BNAndPad`` writes its pad value
only at the map's top and bottom.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import spike_op
from ..ops.spike import multispike8, multispike_norm, qspike
from ..parallel import spatial
from ..parallel.mesh import batch_moments
from ..parallel.tp import COLUMN, copy_to_model, reduce_from_model

# kind -> (function, level D): a spike is k / D with k in 0..D, the packed
# code of a spike-input site is k, and a site's firing rate is mean(y) * D
SPIKE_FNS = {"qspike": (qspike, 8.0),
             "multispike_norm": (multispike_norm, 4.0),
             "multispike8": (multispike8, 8.0)}


def spike_code_scale(spike_input: bool | str | None) -> float | None:
    """The code scale D of a site whose input is a ``spike_input`` spike
    (``True`` is ``qspike``), or None for a site that takes no spike."""
    if not spike_input:
        return None
    return SPIKE_FNS["qspike" if spike_input is True else spike_input][1]


def fold_t(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """[T, B, ...] -> [(T*B), ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:])), x.shape[0]


def unfold_t(x: torch.Tensor, t: int) -> torch.Tensor:
    return x.reshape((t, -1) + tuple(x.shape[1:]))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (float32 parameters) that computes in
    ``compute_dtype``; ``spike_input`` marks a conv whose input is a spike
    output (its kind, or ``True`` for ``qspike``), ``packed``
    (``set_packed_residuals``) saves it packed."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32,
                 spike_input: bool | str = False, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype
        self.spike_input = bool(spike_input)
        self.code_scale = spike_code_scale(spike_input)
        self.packed = False


class Linear(nn.Linear):
    """``nn.Linear`` (float32 parameters) over the last axis that computes
    in ``compute_dtype``, as flax's ``nn.Dense`` and width-1 ``nn.Conv``
    with ``dtype=``; ``spike_input`` and ``packed`` as ``Conv2d``.

    ``tp`` (set by ``parallel.tp.shard_params_tp``): None, or
    ``(kind, group)``: column-parallel (this rank's output rows; the
    input's gradient summed over the model group) or row-parallel (this
    rank's input columns; the float32 partial products summed over the
    group, then rounded to the compute dtype, then the bias)."""

    tp = None

    def __init__(self, cin: int, cout: int, bias: bool = True, *,
                 dtype: torch.dtype = torch.float32,
                 spike_input: bool | str = False):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = dtype
        self.spike_input = bool(spike_input)
        self.code_scale = spike_code_scale(spike_input)
        self.packed = False

    def forward(self, x):
        dt = self.compute_dtype
        if self.tp is not None:
            kind, group = self.tp
            if kind != COLUMN:
                return self._row_parallel(x, group)
            x = copy_to_model(x, group)
        fused = _bias_fused(dt)
        if self.packed and torch.is_grad_enabled():
            out = spike_op.spike_linear(x, self.weight,
                                        self.bias if fused else None, dt,
                                        self.code_scale)
        else:
            out = F.linear(x.to(dt), self.weight.to(dt),
                           self.bias.to(dt) if fused and self.bias is not None
                           else None)
        return out if fused or self.bias is None else out + self.bias.to(dt)

    def _row_parallel(self, x, group):
        """This rank's share of the product, exact products of the
        compute-dtype operands summed in float32 (the one-process layer's
        accumulator), summed over ``group``, rounded, plus the bias."""
        dt = self.compute_dtype
        w = self.weight if dt == torch.float32 else self.weight.to(dt).float()
        if self.packed and torch.is_grad_enabled():
            part = spike_op.spike_linear(x, w, None, torch.float32,
                                         self.code_scale)
        else:
            part = F.linear(x.to(dt).float(), w)
        out = reduce_from_model(part, group).to(dt)
        return out if self.bias is None else out + self.bias.to(dt)


def _bias_fused(dt: torch.dtype) -> bool:
    """Whether a layer computing in ``dt`` hands its bias to the product
    (float32) or adds it after, rounded to ``dt`` twice as flax's
    ``y = dot(x, w); y += b`` is."""
    return dt == torch.float32


def set_packed_residuals(model: nn.Module, enabled: bool) -> None:
    """Switch every spike-input conv and dense layer of ``model`` to the
    packed residuals of ``ops/spike_op.py`` (``train.packed_residuals``),
    or back.  Outputs and gradients do not change."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)) and m.spike_input:
            m.packed = enabled


def conv_nhwc(conv: Conv2d, x: torch.Tensor, halo: bool = True
              ) -> torch.Tensor:
    """Apply an NCHW ``Conv2d`` to an NHWC tensor in its compute dtype.
    Inside ``parallel.spatial_sharding()`` (``halo``: unless the caller
    has put the rows around the band in ``x`` itself) a kernel taller than
    one row reads its halo from the neighbouring bands and zero rows only
    at the map's top and bottom (``_spatial_rows``); a one-row kernel's
    row padding goes to the first band's top and the last band's bottom
    only (``_edge_rows``)."""
    dt = conv.compute_dtype
    fused = _bias_fused(dt)
    bias = conv.bias if fused else None
    padding = conv.padding
    if halo and spatial.bands() is not None and (conv.kernel_size[0] > 1
                                                 or conv.padding[0]):
        x = (_spatial_rows(conv, x) if conv.kernel_size[0] > 1
             else _edge_rows(conv, x))
        padding = (0, conv.padding[1])
    if conv.packed and torch.is_grad_enabled():
        out = spike_op.spike_conv(
            x, conv.weight, bias, dt, conv.code_scale, stride=conv.stride,
            padding=padding, dilation=conv.dilation, groups=conv.groups)
    else:
        out = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                       None if bias is None else bias.to(dt), conv.stride,
                       padding, conv.dilation,
                       conv.groups).permute(0, 2, 3, 1)
    return out if fused or conv.bias is None else out + conv.bias.to(dt)


def _spatial_rows(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The rows of the whole map that ``conv`` (kernel k, stride s, pad
    p, dilation d) reads for this band's output rows, as one tensor: the
    p rows above the band and the ``d(k-1) - p - s + 1`` below it from the
    neighbours (zeros off the map), or the band cut by as many rows where
    that is negative; an unpadded convolution of it gives the band's
    ``H_band / s`` output rows."""
    k, s = conv.kernel_size[0], conv.stride[0]
    p, d = conv.padding[0], conv.dilation[0]
    band = x.shape[1]
    if band % s:
        raise ValueError(f"a band of {band} rows does not split into "
                         f"stride {s}")
    below = d * (k - 1) - p - s + 1
    if below < 0:
        x, below = x[:, :band + below], 0
    return spatial.halo(x, 1, p, below)[0]


def _edge_rows(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The band of a one-row kernel with row padding p (stride 1): the map
    it pads has p zero rows above the first band and below the last, so
    those bands give p output rows more than the others."""
    if conv.stride[0] != 1:
        raise ValueError("a strided one-row convolution with row padding "
                         "has no row-sharded form")
    b, p = spatial.bands(), conv.padding[0]
    return F.pad(x, (0, 0, 0, 0, p if b.rank == 0 else 0,
                     p if b.rank == b.size - 1 else 0))


def conv2d(cin: int, cout: int, k: int = 1, stride: int = 1, pad: int = 0,
           groups: int = 1, bias: bool = False,
           dtype: torch.dtype = torch.float32,
           spike_input: bool | str = False) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=pad, groups=groups,
                  bias=bias, dtype=dtype, spike_input=spike_input)


_OBSERVE = threading.local()


class Spike(nn.Module):
    """Quantized spike site of ``kind`` (``SPIKE_FNS``), in its input's
    dtype.

    Each site of the JAX package's model is one ``Spike`` submodule here,
    named as flax names it (``Spike_0``, ``Spike_1``, ... in call order, or
    the JAX module's explicit name), so ``observe_spikes`` reports the
    same site names as JAX's ``spikes`` collection."""

    def __init__(self, kind: str = "qspike"):
        super().__init__()
        self.kind = kind
        self.fn, self.level = SPIKE_FNS[kind]

    def extra_repr(self) -> str:
        return self.kind

    def forward(self, x):
        y = self.fn(x)
        sink = getattr(_OBSERVE, "sink", None)
        if sink is not None:
            sink(self, y)
        return y


@contextlib.contextmanager
def observe_spikes(model: nn.Module):
    """Record the firing statistics of every ``Spike`` site of ``model``
    that runs inside the block (in this thread), as JAX's ``Spike`` sows
    them (models/layers.py:74-93): ``{path}/rate`` = ``mean(y) * D`` (D
    the site kind's level) and
    ``{path}/nonfire`` = ``mean(y == 0)``, with ``path`` the site's module
    path joined by ``/``.  A site that runs more than once keeps its first
    call's values.  Yields the dict, filled as the forward runs, of 0-dim
    float32 tensors on the model's device.  Outside the block a site
    computes nothing but its spike."""
    names = {m: n.replace(".", "/") for n, m in model.named_modules()
             if isinstance(m, Spike)}
    stats: dict[str, torch.Tensor] = {}

    def sink(mod: Spike, y: torch.Tensor) -> None:
        name = names.get(mod)
        if name is None or f"{name}/rate" in stats:
            return
        yf = y.detach().float()
        stats[f"{name}/rate"] = yf.mean() * mod.level
        stats[f"{name}/nonfire"] = (yf == 0).float().mean()

    prev = getattr(_OBSERVE, "sink", None)
    _OBSERVE.sink = sink
    try:
        yield stats
    finally:
        _OBSERVE.sink = prev


MOMENTUM = 0.9  # flax convention: ra = m * ra + (1 - m) * batch
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """BN running statistics stay as they are inside the block (in this
    thread): the recomputation of a ``remat`` block."""
    prev = getattr(_RECOMPUTE, "frozen", False)
    _RECOMPUTE.frozen = True
    try:
        yield
    finally:
        _RECOMPUTE.frozen = prev


def _update_running(ra: torch.Tensor, batch: torch.Tensor) -> None:
    if getattr(_RECOMPUTE, "frozen", False):
        return
    with torch.no_grad():
        ra.copy_(MOMENTUM * ra + (1.0 - MOMENTUM) * batch)


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of saving its
    activations (flax's ``nn.remat``), under ``frozen_running_stats``; a
    plain call where no gradient is recorded."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_running_stats()))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, flax's arithmetic order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  In training mode
    the statistics are the batch's over all leading axes (biased variance)
    and the running statistics move towards them.

    flax computes the variance as ``max(0, E[x^2] - E[x]^2)``; the port
    takes ``torch.var_mean``, the same statistic without the cancellation:
    on a channel that is constant over the batch (a conv of all-zero
    spikes gives its bias) the one-pass form leaves f32 rounding noise of
    order ``bias^2 * 1e-7`` against ``eps = 1e-5``, which moves that
    channel's gradient by up to a percent.  Inside
    ``parallel.global_batch()`` the statistics are the global batch's,
    over every rank's rows (``parallel.batch_moments``)."""

    # the JAX wrapper's inner flax ``nn.BatchNorm`` (``engine/convert.py``)
    flax_scope = ("BatchNorm_0",)

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, var = batch_moments(xf)
            _update_running(self.mean, mean)
            _update_running(self.var, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class ConvBN(nn.Module):
    """Conv2d (+ optional bias) then BatchNorm, on [(T*B), H, W, C]."""

    def __init__(self, cin, cout, k=1, stride=1, pad=0, bias=False,
                 dtype=torch.float32, spike_input=False):
        super().__init__()
        self.Conv_0 = conv2d(cin, cout, k, stride, pad, bias=bias,
                             dtype=dtype, spike_input=spike_input)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return self.BatchNorm_0(conv_nhwc(self.Conv_0, x))


class BNAndPad(nn.Module):
    """BatchNorm, then a 1px border filled with the BN's response to a zero
    input, so a following VALID 3x3 conv sees the halo a padded-then-BN'd
    input would give (sdtv2.py:48-109).  In training mode the statistics are
    the batch's (biased variance, two-pass as the JAX module's ``jnp.var``)
    and the pad value reads the running statistics after their update, with
    the affine parameters detached, as the JAX module does.  There the
    updated running statistics are traced values of the batch's, so the
    pad value passes the batch statistics' gradient on (times ``1 -
    momentum``), where the reference's buffers pass none: the port follows
    JAX.  Inside ``parallel.global_batch()`` the statistics are the global
    batch's, as ``BatchNorm``'s."""

    def __init__(self, c: int, pad_pixels: int = 1, eps: float = 1e-5):
        super().__init__()
        self.p, self.eps = pad_pixels, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        xf = x.float()
        ra_mean, ra_var = self.mean, self.var
        if self.training:
            mean, var = batch_moments(xf)
            _update_running(self.mean, mean)
            _update_running(self.var, var)
            # the updated statistics' values, with the batch's gradient
            ra_mean = self.mean + (1.0 - MOMENTUM) * (mean - mean.detach())
            ra_var = self.var + (1.0 - MOMENTUM) * (var - var.detach())
        else:
            mean, var = self.mean, self.var
        y = ((xf - mean) * torch.rsqrt(var + self.eps) * self.scale
             + self.bias).to(x.dtype)
        p = self.p
        pad_value = (self.bias.detach() - ra_mean * self.scale.detach()
                     * torch.rsqrt(ra_var + self.eps)).to(y.dtype)
        if spatial.bands() is not None:
            # a row band: the neighbours' BN'd rows, the pad value only at
            # the map's top and bottom
            y = spatial.halo(y, 1, p, p, edge=pad_value)[0]
            p_h = 0
        else:
            p_h = p
        n, h, w, c = y.shape
        out = pad_value.expand(n, h + 2 * p_h, w + 2 * p, c).clone()
        out[:, p_h:h + p_h, p:w + p] = y
        return out


class RepConv(nn.Module):
    """1x1 -> BNAndPad(1) -> dw3x3 VALID -> 1x1 -> BN (sdtv2.py:112-132)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32,
                 spike_input: bool = False):
        super().__init__()
        self.Conv_0 = conv2d(cin, cin, 1, dtype=dtype,
                             spike_input=spike_input)
        self.BNAndPad_0 = BNAndPad(cin)
        self.Conv_1 = conv2d(cin, cin, 3, groups=cin, dtype=dtype)
        self.Conv_2 = conv2d(cin, cout, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        x = conv_nhwc(self.Conv_0, x)
        x = self.BNAndPad_0(x)
        x = conv_nhwc(self.Conv_1, x, halo=False)   # BNAndPad's halo
        x = conv_nhwc(self.Conv_2, x)
        return self.BatchNorm_0(x)


class SepConv(nn.Module):
    """Inverted separable conv with spikes of kind ``spike`` on
    [T, B, H, W, C].

    ``dw_bn=False, num_spikes=2`` is sdtv2's SepConv;
    ``dw_bn=True, num_spikes=3`` is SepConv_Spike (SNN_core.py:11-63).
    """

    def __init__(self, dim, expansion_ratio=2, kernel_size=7, padding=3,
                 dw_bn=False, num_spikes=2, dtype=torch.float32,
                 spike="qspike"):
        super().__init__()
        med = int(expansion_ratio * dim)
        self.Spike_0, self.Spike_1 = Spike(spike), Spike(spike)
        self.Spike_2 = Spike(spike) if num_spikes >= 3 else None
        self.ConvBN_0 = ConvBN(dim, med, 1, dtype=dtype, spike_input=spike)
        self.Conv_0 = conv2d(med, med, kernel_size, pad=padding, groups=med,
                             dtype=dtype, spike_input=spike)
        self.BatchNorm_0 = BatchNorm(med) if dw_bn else None
        self.ConvBN_1 = ConvBN(med, dim, 1, dtype=dtype,
                               spike_input=num_spikes >= 3 and spike)

    def forward(self, x):
        xf, t = fold_t(x)
        xf = self.ConvBN_0(self.Spike_0(xf))
        xf = conv_nhwc(self.Conv_0, self.Spike_1(xf))
        if self.BatchNorm_0 is not None:
            xf = self.BatchNorm_0(xf)
        if self.Spike_2 is not None:
            xf = self.Spike_2(xf)
        return unfold_t(self.ConvBN_1(xf), t)


class MSConvBlock(nn.Module):
    """x += SepConv(x); then spike->3x3(4x)->BN->spike->3x3->BN residual
    (sdtv2.py:183-219); SDTv3's with ``sepconv_dw_bn=True``,
    ``sepconv_num_spikes=3`` (SepConv_Spike) and its spike kind."""

    def __init__(self, dim: int, mlp_ratio: int = 4, dtype=torch.float32,
                 sepconv_dw_bn: bool = False, sepconv_num_spikes: int = 2,
                 spike: str = "qspike"):
        super().__init__()
        self.Spike_0, self.Spike_1 = Spike(spike), Spike(spike)
        self.SepConv_0 = SepConv(dim, dw_bn=sepconv_dw_bn,
                                 num_spikes=sepconv_num_spikes, dtype=dtype,
                                 spike=spike)
        self.ConvBN_0 = ConvBN(dim, dim * mlp_ratio, 3, pad=1, dtype=dtype,
                               spike_input=spike)
        self.ConvBN_1 = ConvBN(dim * mlp_ratio, dim, 3, pad=1, dtype=dtype,
                               spike_input=spike)

    def forward(self, x):
        x = x + self.SepConv_0(x)
        xf, t = fold_t(x)
        xf = self.ConvBN_0(self.Spike_0(xf))
        xf = self.ConvBN_1(self.Spike_1(xf))
        return x + unfold_t(xf, t)


class MSMLP(nn.Module):
    """Pointwise spiking MLP over [T, B, H, W, C] (sdtv2.py:222-255)."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32,
                 spike: str = "qspike"):
        super().__init__()
        self.Spike_0, self.Spike_1 = Spike(spike), Spike(spike)
        self.Conv_0 = conv2d(dim, hidden, 1, bias=True, dtype=dtype,
                             spike_input=spike)
        self.BatchNorm_0 = BatchNorm(hidden)
        self.Conv_1 = conv2d(hidden, dim, 1, bias=True, dtype=dtype,
                             spike_input=spike)
        self.BatchNorm_1 = BatchNorm(dim)

    def forward(self, x):
        xf, t = fold_t(x)
        xf = self.BatchNorm_0(conv_nhwc(self.Conv_0, self.Spike_0(xf)))
        xf = self.BatchNorm_1(conv_nhwc(self.Conv_1, self.Spike_1(xf)))
        return unfold_t(xf, t)


class DownSampling(nn.Module):
    """(spike->)conv(k, s, p)->BN stage transition (sdtv2.py:386-421)."""

    def __init__(self, cin, cout, kernel=3, stride=2, padding=1,
                 first_layer=False, dtype=torch.float32,
                 spike: str = "qspike"):
        super().__init__()
        self.Spike_0 = None if first_layer else Spike(spike)
        self.Conv_0 = conv2d(cin, cout, kernel, stride, padding, bias=True,
                             dtype=dtype,
                             spike_input=not first_layer and spike)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        xf, t = fold_t(x)
        if self.Spike_0 is not None:
            xf = self.Spike_0(xf)
        xf = self.BatchNorm_0(conv_nhwc(self.Conv_0, xf))
        return unfold_t(xf, t)
