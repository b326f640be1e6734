"""CycleMLP token mixer (port of ``spike2former_tpu/models/cyclemlp.py``;
reference mmcv_spike/CycleMLP.py :54-197): ``CycleFC`` shifts each input
channel along one spatial axis by the staircase ``s_i = (i + K//2) % K -
K//2`` with zero fill (the reference's ``deform_conv2d`` with constant
integer offsets) and projects 1x1; ``CycleMLP`` fuses an h and a w
staircase and a channel branch by a softmax reweighting; ``CycleBlock``
is the pre-LayerNorm residual block.  Channels-last [B, H, W, C].
flax's LayerNorm (eps 1e-6) and exact erf GELU, as the JAX modules.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


def cycle_shift(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Channel ``i`` of ``x`` [..., C] shifted along ``axis`` by ``(i +
    k//2) % k - k//2`` (``out[w] = x[w + s]``), zero-filled."""
    c, n = x.shape[-1], x.shape[axis]
    shifts = (torch.arange(c, device=x.device) + k // 2) % k - k // 2
    out = torch.zeros_like(x)
    for s in range(-(k // 2), k - k // 2):
        sel = shifts == s
        if not bool(sel.any()):
            continue
        lo, hi = max(0, -s), min(n, n - s)   # output rows with a source
        if hi <= lo:
            continue
        src = x.narrow(axis, lo + s, hi - lo)
        out.narrow(axis, lo, hi - lo).copy_(
            torch.where(sel, src, out.narrow(axis, lo, hi - lo)))
    return out


class CycleFC(nn.Module):
    """Staircase shift along W (``kernel_size`` (1, K)) or H ((K, 1)),
    then a dense projection: [..., H, W, C] -> [..., H, W, features]."""

    def __init__(self, cin: int, features: int, kernel_size=(1, 3),
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        kh, kw = kernel_size
        if kh != 1 and kw != 1:
            raise ValueError(f"a staircase runs along one axis: "
                             f"{kernel_size}")
        self.k, self.along_w = kh * kw, kh == 1
        self.Dense_0 = Linear(cin, features, bias=use_bias, dtype=dtype)

    def forward(self, x):
        axis = x.dim() - 2 if self.along_w else x.dim() - 3
        return self.Dense_0(cycle_shift(x, self.k, axis))


class CycleMLP(nn.Module):
    """The three-branch mixer with softmax reweighting (CycleMLP.py
    :147-175), on [B, H, W, C]."""

    def __init__(self, dim: int, use_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.sfc_h = CycleFC(dim, dim, (1, 3), dtype=dtype)
        self.sfc_w = CycleFC(dim, dim, (3, 1), dtype=dtype)
        self.mlp_c = Linear(dim, dim, bias=use_bias, dtype=dtype)
        self.re_fc1 = Linear(dim, dim // 4, dtype=dtype)
        self.re_fc2 = Linear(dim // 4, dim * 3, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        h, w, ch = self.sfc_h(x), self.sfc_w(x), self.mlp_c(x)
        a = (h + w + ch).mean((1, 2))                            # [B, C]
        a = self.re_fc2(F.gelu(self.re_fc1(a)))
        a = torch.softmax(a.reshape(-1, self.dim, 3), -1)[:, None, None]
        return self.proj(h * a[..., 0] + w * a[..., 1] + ch * a[..., 2])


class CycleBlock(nn.Module):
    """Pre-LN residual block with ``skip_lam`` scaling (CycleMLP.py
    :177-197)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 skip_lam: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.skip_lam = skip_lam
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = CycleMLP(dim, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = Linear(dim, hidden, dtype=dtype)
        self.mlp_fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) / self.skip_lam
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + y / self.skip_lam
