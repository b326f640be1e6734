"""MaskFormer head, DETR decoder path (port of
``spike2former_tpu/models/maskformer_head.py``).

pixel decoder -> 3 scale levels (+ sine PE + level embed) -> decoder layers
round-robin over the levels -> SDME output block (sigmoid -> Q-IF spike ->
x alpha; linear classes averaged over T; mask embeddings by a 3-layer spiking
MLP plus a query-mixing shortcut, a final spike, and an einsum with the mask
features averaged over T).  In training mode (``model.train()``) every
decoder layer's output is returned, the initial queries' too, and the
query-axis BN uses batch statistics; with ``lazy_masks`` the mask logits
come in the factored ``LazyMasks`` form.  ``valid_hw`` masks the padding
of bucket-padded eval inputs.  Masked attention is not ported yet.

Mixed precision follows the JAX head: the queries, query embeddings,
level embeddings and positional encodings are float32 parameters or
made in float32, so the decoder's residual stream is float32 while its
convolutions compute in ``dtype``; the SDME sigmoid runs in float32, the
class scores come back in float32 and the mask logits are float32 sums
of the embeddings and the mask features (JAX ``maskformer_head.py``
:194-218).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..losses.criterion import LazyMasks
from .attention import SpikeMLP3
from .layers import BatchNorm, Linear, Spike
from .pixel_decoder import DCNPixelDecoder
from .positional import sine_pe_for_shape, sine_positional_encoding
from .transformer_decoder import DetrDecoderLayer


class MaskFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 360),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_classes: int = 150, num_queries: int = 100,
                 num_decoder_layers: int = 6, num_feat_levels: int = 3,
                 num_heads: int = 8, decoder_ffn_channels: int = 2048,
                 encoder_ffn_channels: int = 1024,
                 num_encoder_layers: int = 6, dcn_group: int = 32,
                 dw_kernel_size: int = 5, alpha: float = 4.0,
                 eval_last_only: bool = True, lazy_masks: bool = False,
                 compat: bool = False, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        c, nq = feat_channels, num_queries
        self.c, self.alpha = c, alpha
        self.num_decoder_layers = num_decoder_layers
        self.num_feat_levels = num_feat_levels
        self.eval_last_only = eval_last_only
        self.lazy_masks = lazy_masks
        self.pixel_decoder = DCNPixelDecoder(
            in_channels, c, out_channels, num_encoder_layers,
            encoder_ffn_channels, dcn_group, dw_kernel_size, compat=compat,
            remat=remat, dtype=dtype)
        self.query_feat = nn.Parameter(torch.zeros(nq, c))
        self.query_embed = nn.Parameter(torch.zeros(nq, c))
        self.level_embed = nn.Parameter(torch.zeros(num_feat_levels, c))
        for i in range(num_decoder_layers):
            setattr(self, f"decoder_{i}", DetrDecoderLayer(
                c, num_heads, decoder_ffn_channels, compat=compat,
                dtype=dtype))
        self.decoder_out_spike = Spike()
        self.shortcut_spike = Spike()
        self.mask_embed_spike = Spike()
        self.cls_embed = Linear(c, num_classes + 1, dtype=dtype)
        self.mask_embed = SpikeMLP3(c, out_channels, quant_const=alpha,
                                    dtype=dtype)
        self.shortcut_bn = BatchNorm(nq)
        self.shortcut_kernel = nn.Parameter(torch.zeros(nq, nq))
        self.w = nn.Parameter(torch.ones(1))

    def sdme_embed(self, out: torch.Tensor):
        """out [L, T, B, nq, C] query features -> class scores
        [L, B, nq, ncls+1] and post-spike mask embeddings [L, T, B, nq, C]
        (the factored half of the mask logits)."""
        a = self.alpha
        out_sig = torch.sigmoid(out.float()).to(out.dtype)
        out_spiked = a * self.decoder_out_spike(out_sig)
        cls_scores = self.cls_embed(out_spiked).mean(1)
        mask_embed = self.mask_embed(out_spiked)
        # shortcut: a conv over the QUERY axis + BN over queries
        # (maskformer_head.py:152-155,576-579), in the promoted dtype
        sc = a * self.shortcut_spike(out_sig)
        dt = torch.promote_types(sc.dtype, self.shortcut_kernel.dtype)
        sc = torch.einsum("ltbqc,pq->ltbpc", sc.to(dt),
                          self.shortcut_kernel.to(dt))
        sc = self.shortcut_bn(sc.movedim(3, -1)).movedim(-1, 3)
        mask_embed = a * self.mask_embed_spike(mask_embed + self.w * sc)
        return cls_scores.float(), mask_embed

    def sdme(self, out: torch.Tensor, mask_features: torch.Tensor):
        """out [L, T, B, nq, C] -> class scores [L, B, nq, ncls+1] and mask
        logits [L, B, nq, h, w]."""
        cls_scores, mask_embed = self.sdme_embed(out)
        t = mask_features.shape[0]
        mask_preds = torch.einsum("ltbqc,tbhwc->lbqhw", mask_embed.float(),
                                  mask_features.float()) / t
        return cls_scores, mask_preds

    def forward(self, feats: Sequence[torch.Tensor],
                valid_hw: torch.Tensor | None = None):
        """feats: 4-level pyramid [T,B,h,w,c] -> (cls [L, B, nq, ncls+1],
        masks [L, B, nq, H/2, W/2]): L = 1 in eval mode with
        ``eval_last_only``, else L = num_decoder_layers + 1; in training
        mode with ``lazy_masks`` the masks are ``LazyMasks``.

        ``valid_hw`` ([B, 2] int, the valid extents at input resolution of
        bottom-right padded inputs): at each level the padded tokens
        (the extents ceil-divided by the level's stride) are left out of
        the sine PE's normalisation and masked out of the cross-attention
        keys (their scores zeroed), so the valid region matches an
        exact-shape forward up to the convolutions' halo across the
        padding edge."""
        c = self.c
        mask_features, memory, multi_scale = self.pixel_decoder(feats)
        t, b = memory.shape[:2]
        nq = self.query_feat.shape[0]
        input_h = feats[0].shape[2] * 2   # feats[0] is the /2 level

        inputs, pes, key_masks = [], [], []
        for i in range(self.num_feat_levels):
            lvl = multi_scale[i]
            h, w = lvl.shape[2:4]
            inputs.append(lvl.reshape(t, b, h * w, c) + self.level_embed[i])
            if valid_hw is None:
                pe = sine_pe_for_shape(h, w, c // 2, device=lvl.device)
                pes.append(pe.reshape(h * w, c).expand(b, h * w, c))
                key_masks.append(None)
                continue
            stride = input_h // h
            vh, vw = (-(-valid_hw.to(lvl.device).long() // stride)).unbind(1)
            pad = ((torch.arange(h, device=lvl.device)[None, :, None]
                    >= vh[:, None, None])
                   | (torch.arange(w, device=lvl.device)[None, None, :]
                      >= vw[:, None, None]))                 # [B, h, w]
            pes.append(sine_positional_encoding(pad, c // 2).reshape(
                b, h * w, c))
            key_masks.append(pad.reshape(b, 1, 1, h * w))

        query = self.query_feat.expand(t, b, nq, c)
        qpos = self.query_embed.expand(b, nq, c)
        out_dec = [query]  # the initial queries are supervised too
        for i in range(self.num_decoder_layers):
            lvl = i % self.num_feat_levels
            query = getattr(self, f"decoder_{i}")(
                query, inputs[lvl], inputs[lvl], qpos, pes[lvl],
                cross_attn_mask=key_masks[lvl])
            out_dec.append(query)
        if self.training or not self.eval_last_only:
            out = torch.stack(out_dec)
        else:  # the reference discards all but the last layer at inference
            out = query[None]
        if self.training and self.lazy_masks:
            cls_scores, mask_embed = self.sdme_embed(out)
            return cls_scores, LazyMasks(mask_embed, mask_features)
        return self.sdme(out, mask_features)


def semantic_inference(cls_scores: torch.Tensor, mask_preds: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``einsum(softmax(cls)[..., :-1], sigmoid(masks))``: cls [B, nq,
    ncls+1], masks [B, nq, H, W] -> [B, H, W, ncls] channels-last, in
    ``dtype``: the operands are cast to it and the product sums in f32 and
    rounds once (JAX ``maskformer_head.py:335-350``)."""
    cls_prob = torch.softmax(cls_scores.float(), -1)[..., :-1].to(dtype)
    mask_prob = torch.sigmoid(mask_preds).to(dtype)
    return torch.einsum("bqc,bqhw->bhwc", cls_prob, mask_prob)
