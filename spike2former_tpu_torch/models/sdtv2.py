"""SDTv2 Meta-SpikeFormer backbone (port of ``spike2former_tpu/models/sdtv2.py``,
``variant="sdtv2"`` only).

Four stages of conv-BN-spike blocks and spike-driven linear attention,
returning a 4-level pyramid ``[T, B, H/s, W/s, C_s]`` for s in (2, 4, 8, 16).
``dtype`` is the convolutions' compute dtype; ``remat`` recomputes each
``MSConvBlock`` and ``MSBlock`` in the backward (``layers.remat``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (BatchNorm, DownSampling, MSConvBlock, MSMLP, RepConv,
                     Spike, fold_t, remat, unfold_t)


class SpikeAttention(nn.Module):
    """SDTv2's MS_Attention_RepConv_qkv_id (sdtv2.py:258-344): softmax-free,
    associated as ``q @ (k^T v)``.  Input/output [T, B, H, W, C].

    The contractions take the spikes in their dtype and accumulate in f32
    (JAX's ``preferred_element_type``): ``k^T v`` is rounded to the
    activation dtype before the second product, whose f32 sum is scaled and
    then rounded (sdtv2.py:86-88).  A bf16 product on the card accumulates
    in f32 and rounds once, which is the first; the second runs on f32
    copies of its bf16 operands, so that the scale comes before the
    rounding."""

    def __init__(self, dim: int, num_heads: int = 8, dtype=torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.scale = (dim // num_heads) ** -0.5
        # Spike_0 on the input, Spike_1-3 on q, k and v, Spike_4 before
        # the output projection (JAX's call order)
        for i in range(5):
            setattr(self, f"Spike_{i}", Spike())
        for name in ("q", "k", "v", "proj"):
            setattr(self, f"{name}_rep",
                    RepConv(dim, dim, dtype=dtype, spike_input=True))
            setattr(self, f"{name}_bn", BatchNorm(dim))

    def forward(self, x):
        t, b, h, w, c = x.shape
        n, nh = h * w, self.num_heads
        xf = self.Spike_0(fold_t(x)[0])

        def proj(name, spike):
            y = getattr(self, f"{name}_bn")(getattr(self, f"{name}_rep")(xf))
            # [(T*B), H, W, C] -> [T*B, heads, N, C/heads]
            return spike(y).reshape(t * b, n, nh, c // nh).transpose(1, 2)

        q = proj("q", self.Spike_1)
        k = proj("k", self.Spike_2)
        v = proj("v", self.Spike_3)
        kv = k.transpose(-1, -2) @ v
        out = ((q.float() @ kv.float()) * self.scale).to(x.dtype)
        out = out.transpose(1, 2).reshape(t * b, h, w, c)
        out = self.proj_bn(self.proj_rep(self.Spike_4(out)))
        return unfold_t(out, t)


class MSBlock(nn.Module):
    """attn + MLP residuals (sdtv2.py:347-383 MS_Block)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.SpikeAttention_0 = SpikeAttention(dim, num_heads, dtype=dtype)
        self.MSMLP_0 = MSMLP(dim, dim * mlp_ratio, dtype=dtype)

    def forward(self, x):
        x = x + self.SpikeAttention_0(x)
        return x + self.MSMLP_0(x)


class SpikingMetaFormer(nn.Module):
    """Spiking_vit_MetaFormer (sdtv2.py:424-655).

    ``collapse_t``: every spike is a stateless elementwise quantizer and the
    same image is broadcast to all T steps, so the T slices are identical;
    compute one step instead of T.

    ``norm_eval``: the reference trains with every backbone BN in eval mode
    (sdtv2.py:571-575, config ``norm_eval=True``): running statistics stay
    frozen while the affine parameters still train.  The training flag only
    gates BN here, so ``train()`` keeps the backbone in eval mode.
    """

    def __init__(self, embed_dim: Sequence[int] = (64, 128, 256, 360),
                 num_heads: int = 8, mlp_ratio: int = 4, in_channels: int = 3,
                 T: int = 1, depths_stage3: int = 6, depths_stage4: int = 2,
                 collapse_t: bool = False, norm_eval: bool = False,
                 remat: bool = False, dtype=torch.float32):
        super().__init__()
        e = embed_dim
        self.T, self.collapse_t, self.norm_eval = T, collapse_t, norm_eval
        self.remat = remat
        self.depths = (depths_stage3, depths_stage4)
        dt = dict(dtype=dtype)
        self.down1_1 = DownSampling(in_channels, e[0] // 2, 7, 2, 3,
                                    first_layer=True, **dt)
        self.conv1_1 = MSConvBlock(e[0] // 2, mlp_ratio, **dt)
        self.down1_2 = DownSampling(e[0] // 2, e[0], **dt)
        self.conv1_2 = MSConvBlock(e[0], mlp_ratio, **dt)
        self.down2 = DownSampling(e[0], e[1], **dt)
        self.conv2_1 = MSConvBlock(e[1], mlp_ratio, **dt)
        self.conv2_2 = MSConvBlock(e[1], mlp_ratio, **dt)
        self.down3 = DownSampling(e[1], e[2], **dt)
        for i in range(depths_stage3):
            setattr(self, f"block3_{i}",
                    MSBlock(e[2], num_heads, mlp_ratio, **dt))
        self.down4 = DownSampling(e[2], e[3], stride=1, **dt)
        for i in range(depths_stage4):
            setattr(self, f"block4_{i}",
                    MSBlock(e[3], num_heads, mlp_ratio, **dt))

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
        x = self.down4(x)
        for i in range(self.depths[1]):
            x = self.block(f"block4_{i}", x)
        return [x1, x2, x3, x]
