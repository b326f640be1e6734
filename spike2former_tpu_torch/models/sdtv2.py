"""Meta-SpikeFormer backbones (port of ``spike2former_tpu/models/sdtv2.py``):
SDTv2 (``Spiking_vit_MetaFormer``), SDTv3 / E-SpikeFormer
(``Spiking_vit_MetaFormerv2``) and its MAE-pretrain flavour
(``Spiking_vit_MetaFormerv3``), chosen by ``variant``.

Four stages of conv-BN-spike blocks and spike-driven linear attention,
returning a 4-level pyramid ``[T, B, H/s, W/s, C_s]`` for s in (2, 4, 8, 16).
``dtype`` is the convolutions' compute dtype; ``remat`` recomputes each
conv block and attention block in the backward (``layers.remat``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (BatchNorm, ConvBN, DownSampling, MSConvBlock, MSMLP,
                     RepConv, SepConv, Spike, fold_t, remat, unfold_t)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``q @ (k^T v) * scale`` over [S, heads, N, d] spikes, as JAX sums
    it: ``k^T v`` accumulated in f32 and rounded to the activation dtype,
    the second product in f32, scaled, then rounded to ``dtype``.  A bf16
    product on the card accumulates in f32 and rounds once, which is the
    first; the second runs on f32 copies, so the scale comes before the
    rounding."""
    kv = k.transpose(-1, -2) @ v
    return ((q.float() @ kv.float()) * scale).to(dtype)


class SpikeAttention(nn.Module):
    """Spike-driven linear attention, softmax-free, associated as
    ``q @ (k^T v)``.  Input/output [T, B, H, W, C].

    ``qkv_proj='repconv'`` is SDTv2's MS_Attention_RepConv_qkv_id
    (sdtv2.py:258-344: RepConv + BN projections); ``'conv1x1'`` with
    ``lamda_ratio=4`` (v widened) and ``scale_mult=2`` is SDTv3's
    MS_Attention_linear (sdtv3.py:229-276: 1x1 conv + BN projections)."""

    def __init__(self, dim: int, num_heads: int = 8, dtype=torch.float32,
                 qkv_proj: str = "repconv", lamda_ratio: int = 1,
                 scale_mult: float = 1.0, spike: str = "qspike"):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.cv = dim * lamda_ratio
        self.scale = (dim // num_heads) ** -0.5 * scale_mult
        self.repconv = qkv_proj == "repconv"
        # Spike_0 on the input, Spike_1-3 on q, k and v, Spike_4 before
        # the output projection (JAX's call order)
        for i in range(5):
            setattr(self, f"Spike_{i}", Spike(spike))
        ins = dict(q=dim, k=dim, v=dim, proj=self.cv)
        outs = dict(q=dim, k=dim, v=self.cv, proj=dim)
        for name in ("q", "k", "v", "proj"):
            if self.repconv:
                setattr(self, f"{name}_rep",
                        RepConv(ins[name], outs[name], dtype=dtype,
                                spike_input=spike))
                setattr(self, f"{name}_bn", BatchNorm(outs[name]))
            else:
                setattr(self, f"{name}_conv",
                        ConvBN(ins[name], outs[name], 1, dtype=dtype,
                               spike_input=spike))

    def _proj(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.repconv:
            return getattr(self, f"{name}_bn")(getattr(self, f"{name}_rep")(x))
        return getattr(self, f"{name}_conv")(x)

    def forward(self, x):
        t, b, h, w, c = x.shape
        n, nh = h * w, self.num_heads
        xf = self.Spike_0(fold_t(x)[0])

        def heads(name, spike, feats):
            # [(T*B), H, W, F] -> [T*B, heads, N, F/heads]
            return spike(self._proj(name, xf)).reshape(
                t * b, n, nh, feats // nh).transpose(1, 2)

        q = heads("q", self.Spike_1, self.dim)
        k = heads("k", self.Spike_2, self.dim)
        v = heads("v", self.Spike_3, self.cv)
        out = _attend(q, k, v, self.scale, x.dtype)
        out = out.transpose(1, 2).reshape(t * b, h, w, self.cv)
        return unfold_t(self._proj("proj", self.Spike_4(out)), t)


class CSWinSpikeAttention(nn.Module):
    """sdtv3MAE's striped spiking attention (``MS_Attention_linear_cswin``
    + ``LePEAttention``, sdtv3MAE.py:257-436): 1x1 conv + BN q/k, v
    widened by ``lamda_ratio``; the channels split into two halves that
    attend within vertical and horizontal stripes (``split_num`` of each
    axis), or one global branch when ``last_stage``, with the
    softmax-free ``q (k^T v) * (2 scale)`` form.  The output projection
    computes in float32 and takes no packed residual, as JAX's does.
    Input/output [T, B, H, W, C]."""

    def __init__(self, dim: int, num_heads: int = 8, dtype=torch.float32,
                 lamda_ratio: int = 4, split_num: int = 2,
                 last_stage: bool = False, spike: str = "multispike8"):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.cv = dim * lamda_ratio
        self.split_num, self.last_stage = split_num, last_stage
        self.scale = (dim // num_heads) ** -0.5 * 2
        for i in range(5):
            setattr(self, f"Spike_{i}", Spike(spike))
        self.q_conv = ConvBN(dim, dim, 1, dtype=dtype, spike_input=spike)
        self.k_conv = ConvBN(dim, dim, 1, dtype=dtype, spike_input=spike)
        self.v_conv = ConvBN(dim, self.cv, 1, dtype=dtype, spike_input=spike)
        self.proj_conv = ConvBN(self.cv, dim, 1)

    def _stripes(self, q, k, v, h_num: int, w_num: int, heads: int):
        """Attention within stripes of (H / h_num, W / w_num) tokens of
        [(TB), H, W, Cb] q, k and [(TB), H, W, Cvb] v."""
        tb, hh, ww, cb = q.shape
        cvb = v.shape[-1]
        if hh % h_num or ww % w_num:
            raise ValueError(f"a {hh}x{ww} map does not split into "
                             f"{h_num}x{w_num} stripes")
        hs, ws = hh // h_num, ww // w_num
        n, s = hs * ws, tb * h_num * w_num

        def part(y, ch):
            y = y.reshape(tb, h_num, hs, w_num, ws, ch).permute(
                0, 1, 3, 2, 4, 5)
            return y.reshape(s, n, heads, ch // heads).transpose(1, 2)

        out = _attend(part(q, cb), part(k, cb), part(v, cvb), self.scale,
                      q.dtype)
        out = out.transpose(1, 2).reshape(tb, h_num, w_num, hs, ws, cvb)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(tb, hh, ww, cvb)

    def forward(self, x):
        t, b, h, w, c = x.shape
        xf = self.Spike_0(fold_t(x)[0])
        q = self.Spike_1(self.q_conv(xf))
        k = self.Spike_2(self.k_conv(xf))
        v = self.Spike_3(self.v_conv(xf))
        if self.last_stage:
            out = self._stripes(q, k, v, 1, 1, self.num_heads)
        else:
            half, vhalf, bh = c // 2, self.cv // 2, self.num_heads // 2
            out = torch.cat([
                self._stripes(q[..., :half], k[..., :half], v[..., :vhalf],
                              1, self.split_num, bh),
                self._stripes(q[..., half:], k[..., half:], v[..., vhalf:],
                              self.split_num, 1, bh)], -1)
        return unfold_t(self.proj_conv(self.Spike_4(out)), t)


class MSBlockCSWin(nn.Module):
    """sdtv3MAE's ``MS_Block_cswin`` (sdtv3MAE.py:439-485): residuals over
    SepConv_Spike, CSWin attention and the MLP, each scaled by its
    per-channel gamma (``layer_scale1-3``, 1e-6 at init)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 last_stage: bool = False, layer_scale: float = 1e-6,
                 dtype=torch.float32, spike: str = "multispike8"):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"layer_scale{i}",
                    nn.Parameter(torch.full((dim,), layer_scale)))
        self.SepConv_0 = SepConv(dim, kernel_size=3, padding=1, dw_bn=True,
                                 num_spikes=3, dtype=dtype, spike=spike)
        self.CSWinSpikeAttention_0 = CSWinSpikeAttention(
            dim, num_heads, dtype=dtype, last_stage=last_stage, spike=spike)
        self.MSMLP_0 = MSMLP(dim, dim * mlp_ratio, dtype=dtype, spike=spike)

    def forward(self, x):
        x = x + self.layer_scale1 * self.SepConv_0(x)
        x = x + self.layer_scale2 * self.CSWinSpikeAttention_0(x)
        return x + self.layer_scale3 * self.MSMLP_0(x)


class MSBlock(nn.Module):
    """(SepConv_Spike residual, SDTv3's ``with_sepconv``) + attention + MLP
    residuals (sdtv2.py:347-383 MS_Block; sdtv3.py:318-360
    MS_Block_Spike_SepConv)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=torch.float32, with_sepconv: bool = False,
                 spike: str = "qspike", **attn):
        super().__init__()
        self.SepConv_0 = (SepConv(dim, kernel_size=3, padding=1, dw_bn=True,
                                  num_spikes=3, dtype=dtype, spike=spike)
                          if with_sepconv else None)
        self.SpikeAttention_0 = SpikeAttention(dim, num_heads, dtype=dtype,
                                               spike=spike, **attn)
        self.MSMLP_0 = MSMLP(dim, dim * mlp_ratio, dtype=dtype, spike=spike)

    def forward(self, x):
        if self.SepConv_0 is not None:
            x = x + self.SepConv_0(x)
        x = x + self.SpikeAttention_0(x)
        return x + self.MSMLP_0(x)


VARIANTS = ("sdtv2", "sdtv3", "sdtv3mae")


class SpikingMetaFormer(nn.Module):
    """The 4-stage spiking MetaFormer pyramid.

    ``variant='sdtv2'``: Spiking_vit_MetaFormer (sdtv2.py:424-655), qspike
    (D = 8), RepConv qkv, plain SepConv conv blocks.  ``'sdtv3'``:
    Spiking_vit_MetaFormerv2 (sdtv3.py:401-616), multispike_norm (D = 4),
    1x1 conv qkv with v widened 4x and the scale doubled, SepConv_Spike
    conv blocks and an extra SepConv_Spike residual in the attention
    blocks.  ``'sdtv3mae'``: Spiking_vit_MetaFormerv3 (sdtv3MAE.py:
    526-750), multispike8 (round half up), CSWin striped attention in
    layer-scaled blocks, no stage-4 downsample (both deep stages at
    ``embed_dim[2]``, /16), each level averaged over T (kept as T=1).

    ``collapse_t``: every spike kind is a stateless elementwise quantizer
    and the same image is broadcast to all T steps, so the T slices are
    identical; compute one step instead of T.

    ``norm_eval``: the reference trains with every backbone BN in eval mode
    (sdtv2.py:571-575, config ``norm_eval=True``): running statistics stay
    frozen while the affine parameters still train.  The training flag only
    gates BN here, so ``train()`` keeps the backbone in eval mode.
    """

    def __init__(self, embed_dim: Sequence[int] = (64, 128, 256, 360),
                 num_heads: int = 8, mlp_ratio: int = 4, in_channels: int = 3,
                 T: int = 1, depths_stage3: int = 6, depths_stage4: int = 2,
                 collapse_t: bool = False, norm_eval: bool = False,
                 remat: bool = False, dtype=torch.float32,
                 variant: str = "sdtv2"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown backbone variant {variant!r}; the "
                             f"port has {VARIANTS}")
        e = embed_dim
        self.T, self.collapse_t, self.norm_eval = T, collapse_t, norm_eval
        self.remat, self.variant = remat, variant
        self.mae = mae = variant == "sdtv3mae"
        v3 = variant != "sdtv2"
        spike = ("multispike8" if mae else "multispike_norm" if v3
                 else "qspike")
        self.depths = (depths_stage3, depths_stage4)
        dt = dict(dtype=dtype, spike=spike)
        conv = dict(mlp_ratio=mlp_ratio, sepconv_dw_bn=v3,
                    sepconv_num_spikes=3 if v3 else 2, **dt)
        block = dict(with_sepconv=v3, qkv_proj="conv1x1" if v3 else "repconv",
                     lamda_ratio=4 if v3 else 1,
                     scale_mult=2.0 if v3 else 1.0, **dt)
        self.down1_1 = DownSampling(in_channels, e[0] // 2, 7, 2, 3,
                                    first_layer=True, **dt)
        self.conv1_1 = MSConvBlock(e[0] // 2, **conv)
        self.down1_2 = DownSampling(e[0] // 2, e[0], **dt)
        self.conv1_2 = MSConvBlock(e[0], **conv)
        self.down2 = DownSampling(e[0], e[1], **dt)
        self.conv2_1 = MSConvBlock(e[1], **conv)
        self.conv2_2 = MSConvBlock(e[1], **conv)
        self.down3 = DownSampling(e[1], e[2], **dt)
        for i in range(depths_stage3):
            setattr(self, f"block3_{i}",
                    MSBlockCSWin(e[2], num_heads, mlp_ratio, **dt) if mae
                    else MSBlock(e[2], num_heads, mlp_ratio, **block))
        if not mae:
            self.down4 = DownSampling(e[2], e[3], stride=1, **dt)
        for i in range(depths_stage4):
            setattr(self, f"block4_{i}",
                    MSBlockCSWin(e[2], num_heads, mlp_ratio, last_stage=True,
                                 **dt) if mae
                    else MSBlock(e[3], num_heads, mlp_ratio, **block))

    def train(self, mode: bool = True):
        return super().train(mode and not self.norm_eval)

    def block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A conv block or attention block, under ``remat`` if asked."""
        mod = getattr(self, name)
        return remat(mod, x) if self.remat else mod(x)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """images: [B, H, W, 3] -> 4 pyramid levels [T, B, h, w, c]."""
        t_eff = 1 if self.collapse_t else self.T
        x = images[None].expand((t_eff,) + tuple(images.shape))
        x = self.block("conv1_1", self.down1_1(x))
        x1 = x
        x = self.block("conv1_2", self.down1_2(x))
        x2 = x
        x = self.block("conv2_2", self.block("conv2_1", self.down2(x)))
        x3 = x
        x = self.down3(x)
        for i in range(self.depths[0]):
            x = self.block(f"block3_{i}", x)
        if not self.mae:
            x = self.down4(x)
        for i in range(self.depths[1]):
            x = self.block(f"block4_{i}", x)
        if self.mae:    # the MAE flavour's levels are averaged over T
            return [y.mean(0, keepdim=True) for y in (x1, x2, x3, x)]
        return [x1, x2, x3, x]
