"""MaskFormer head (port of ``spike2former_tpu/models/maskformer_head.py``).

pixel decoder -> 3 scale levels (+ sine PE + level embed) -> decoder layers
round-robin over the levels -> SDME output block (sigmoid -> Q-IF spike ->
x alpha; linear classes averaged over T; mask embeddings by a 3-layer spiking
MLP plus a query-mixing shortcut, a final spike, and an einsum with the mask
features averaged over T).  In training mode (``model.train()``) every
decoder layer's output is returned, the initial queries' too, and the
query-axis BN uses batch statistics; with ``lazy_masks`` the mask logits
come in the factored ``LazyMasks`` form.  ``valid_hw`` masks the padding
of bucket-padded eval inputs.

``masked_attention`` is the Mask2Former mode: the SDME runs after every
layer (and on the initial queries), and its mask logits gate the next
layer's cross-attention keys (``mask2former_attn_mask``); in training mode
the query-axis BN takes each layer's batch statistics apart.
``decoder='dab'`` replaces the decoder layers with the spiking DAB-DETR
decoder (``dab_detr.py``) over the first level, with learned anchors
``query_anchors``.

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
from ..ops.resize import resize_bilinear_hw
from ..parallel import spatial
from . import initializers as init
from .attention import SpikeMLP3
from .dab_detr import DABDetrDecoder
from .layers import BatchNorm, Linear, Spike
from .pixel_decoder import DCNPixelDecoder
from .positional import sine_pe_for_shape, sine_positional_encoding
from .transformer_decoder import DetrDecoderLayer


def mask2former_attn_mask(mask_pred: torch.Tensor, hw: tuple[int, int],
                          pad_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The Mask2Former rule: the previous layer's mask logits [B, nq, h, w],
    resized bilinearly to the attention level ``hw``, mask the keys where
    the logit is below 0 (sigmoid < 0.5), except in a query's row that
    would mask every key, which stays open; ``pad_mask`` ([B, 1, 1, hw],
    True = padding) is ORed in.  Returns [B, 1, nq, h*w] bool, True =
    masked.  Inside ``parallel.spatial_sharding()`` ``mask_pred`` and
    ``hw`` are this rank's row bands and so is the mask; whether a query
    masks every key is decided over every band's keys (one all-reduce of
    the open keys' counts)."""
    b, nq = mask_pred.shape[:2]
    m = resize_bilinear_hw(mask_pred.float(), tuple(hw))
    am = (m < 0.0).reshape(b, nq, -1)
    if spatial.bands() is None:
        all_masked = am.all(-1, keepdim=True)
    else:
        open_keys = (~am).sum(-1, keepdim=True, dtype=torch.int32)
        all_masked = spatial.all_sum_(open_keys) == 0
    am = (am & ~all_masked)[:, None]
    return am if pad_mask is None else am | pad_mask


class MaskFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 360),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_classes: int = 150, num_queries: int = 100,
                 num_decoder_layers: int = 6, num_feat_levels: int = 3,
                 num_heads: int = 8, decoder_ffn_channels: int = 2048,
                 encoder_ffn_channels: int = 1024,
                 num_encoder_layers: int = 6, dcn_group: int = 32,
                 dw_kernel_size: int = 5, alpha: float = 4.0,
                 masked_attention: bool = False, decoder: str = "detr",
                 eval_last_only: bool = True, lazy_masks: bool = False,
                 compat: bool = False, remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if decoder not in ("detr", "dab"):
            raise ValueError(f"unknown decoder {decoder!r}")
        if decoder == "dab" and masked_attention:
            raise ValueError(
                "decoder='dab' does not support masked_attention "
                "(the DAB decoder has no per-layer mask gating); pick one")
        c, nq = feat_channels, num_queries
        self.c, self.alpha = c, alpha
        self.num_decoder_layers = num_decoder_layers
        self.num_feat_levels = num_feat_levels
        self.masked_attention, self.decoder = masked_attention, decoder
        self.eval_last_only = eval_last_only
        self.lazy_masks = lazy_masks
        self.pixel_decoder = DCNPixelDecoder(
            in_channels, c, out_channels, num_encoder_layers,
            encoder_ffn_channels, dcn_group, dw_kernel_size, compat=compat,
            remat=remat, dtype=dtype)
        self.query_feat = nn.Parameter(torch.zeros(nq, c))
        self.query_embed = nn.Parameter(torch.zeros(nq, c))
        self.level_embed = nn.Parameter(torch.zeros(num_feat_levels, c))
        # flax's laws of the head's own parameters (JAX maskformer_head.py):
        # the queries and level embeddings normal(1.0) (:135-140),
        # cls_embed's kernel truncated_normal(0.02) (:174), the shortcut's
        # variance_scaling(1, 'fan_in', 'uniform') over nq (:183-186), w 1
        # (:187), the DAB anchors normal(1.0) (:249-250)
        self.init_laws = {"query_feat": init.normal(1.0),
                          "query_embed": init.normal(1.0),
                          "level_embed": init.normal(1.0),
                          "cls_embed.weight": init.truncated_normal(0.02),
                          "shortcut_kernel": init.uniform_fan_in(nq),
                          "w": init.ones}
        # the order of the head's own self.param calls, which numbers their
        # flax keys (JAX maskformer_head.py:135-140, :183-187, :249)
        self.jax_param_order = ("query_feat", "query_embed", "level_embed",
                                "shortcut_kernel", "w", "query_anchors")
        if decoder == "dab":
            self.query_anchors = nn.Parameter(torch.zeros(nq, 4))
            self.init_laws["query_anchors"] = init.normal(1.0)
            self.dab_decoder = DABDetrDecoder(
                c, num_heads, num_decoder_layers, decoder_ffn_channels,
                dtype=dtype)
        else:
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

    @staticmethod
    def mask_logits(mask_embed: torch.Tensor, mask_features: torch.Tensor
                    ) -> torch.Tensor:
        """Embeddings [L, T, B, nq, C] x mask features [T, B, h, w, C] ->
        float32 logits [L, B, nq, h, w], averaged over T."""
        return torch.einsum("ltbqc,tbhwc->lbqhw", mask_embed.float(),
                            mask_features.float()) / mask_features.shape[0]

    def sdme(self, out: torch.Tensor, mask_features: torch.Tensor):
        """out [L, T, B, nq, C] -> class scores [L, B, nq, ncls+1] and mask
        logits [L, B, nq, h, w]."""
        cls_scores, mask_embed = self.sdme_embed(out)
        return cls_scores, self.mask_logits(mask_embed, mask_features)

    def sdme_out(self, out: torch.Tensor, mask_features: torch.Tensor):
        """The head's output for the query stack ``out`` [L, T, B, nq, C]:
        ``LazyMasks`` in training mode with ``lazy_masks``, else dense."""
        if self.training and self.lazy_masks:
            cls_scores, mask_embed = self.sdme_embed(out)
            return cls_scores, LazyMasks(mask_embed, mask_features)
        return self.sdme(out, mask_features)

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
        padding edge.

        Inside ``parallel.spatial_sharding()`` ``feats`` are this rank's
        row bands, and so are the mask logits: the pad mask is built for
        each level's whole map from the replicated ``valid_hw`` and the
        band keeps its rows of it and of the PE (whose column sums run
        over the whole map), so a band of padding only is masked whole;
        the decoders sum their cross-attention over every band's keys,
        and the queries stay equal on every rank."""
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
            rows = spatial.band_rows(h)
            whole_h = h if rows is None else h * spatial.bands().size
            pad = ((torch.arange(whole_h, device=lvl.device)[None, :, None]
                    >= vh[:, None, None])
                   | (torch.arange(w, device=lvl.device)[None, None, :]
                      >= vw[:, None, None]))           # [B, whole h, w]
            pes.append(sine_positional_encoding(pad, c // 2, rows=rows)
                       .reshape(b, h * w, c))
            if rows is not None:
                pad = pad[:, rows[0]:rows[1]]
            key_masks.append(pad.reshape(b, 1, 1, h * w))

        query = self.query_feat.expand(t, b, nq, c)
        last_only = not self.training and self.eval_last_only
        if self.decoder == "dab":
            outputs, _ = self.dab_decoder(
                query, inputs[0], pes[0],
                self.query_anchors.float().expand(b, nq, 4),
                cross_attn_mask=key_masks[0])
            out = torch.cat([query[None], outputs])
            return self.sdme_out(out[-1:] if last_only else out,
                                 mask_features)
        qpos = self.query_embed.expand(b, nq, c)
        if self.masked_attention:
            return self._mask2former(
                query, qpos, inputs, pes, key_masks,
                [tuple(m.shape[2:4]) for m in multi_scale], mask_features,
                last_only)
        out_dec = [query]  # the initial queries are supervised too
        for i in range(self.num_decoder_layers):
            lvl = i % self.num_feat_levels
            query = getattr(self, f"decoder_{i}")(
                query, inputs[lvl], inputs[lvl], qpos, pes[lvl],
                cross_attn_mask=key_masks[lvl])
            out_dec.append(query)
        # the reference discards all but the last layer at inference
        out = query[None] if last_only else torch.stack(out_dec)
        return self.sdme_out(out, mask_features)

    def _mask2former(self, query, qpos, inputs, pes, key_masks, level_hw,
                     mask_features, last_only: bool):
        """Mask2Former mode: the SDME after every layer, each layer's mask
        logits gating the next layer's cross-attention keys; the initial
        queries' and every layer's outputs are returned (the last only at
        inference under ``eval_last_only``)."""
        lazy = self.training and self.lazy_masks
        cls_list, mask_list, embed_list = [], [], []

        def step_sdme(q):
            cls_i, me_i = self.sdme_embed(q[None])
            # when lazy, the dense logits only gate the next layer
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not lazy):
                mask_i = self.mask_logits(me_i, mask_features)
            cls_list.append(cls_i[0])
            mask_list.append(mask_i[0])
            embed_list.append(me_i[0])

        step_sdme(query)
        for i in range(self.num_decoder_layers):
            lvl = i % self.num_feat_levels
            am = mask2former_attn_mask(mask_list[-1].detach(),
                                       level_hw[lvl], key_masks[lvl])
            query = getattr(self, f"decoder_{i}")(
                query, inputs[lvl], inputs[lvl], qpos, pes[lvl],
                cross_attn_mask=am)
            step_sdme(query)
        if last_only:
            return cls_list[-1][None], mask_list[-1][None]
        if lazy:
            return torch.stack(cls_list), LazyMasks(torch.stack(embed_list),
                                                    mask_features)
        return torch.stack(cls_list), torch.stack(mask_list)


def semantic_inference(cls_scores: torch.Tensor, mask_preds: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``einsum(softmax(cls)[..., :-1], sigmoid(masks))``: cls [B, nq,
    ncls+1], masks [B, nq, H, W] -> [B, H, W, ncls] channels-last, in
    ``dtype``: the operands are cast to it and the product sums in f32 and
    rounds once (JAX ``maskformer_head.py:335-350``)."""
    cls_prob = torch.softmax(cls_scores.float(), -1)[..., :-1].to(dtype)
    mask_prob = torch.sigmoid(mask_preds).to(dtype)
    return torch.einsum("bqc,bqhw->bhwc", cls_prob, mask_prob)
