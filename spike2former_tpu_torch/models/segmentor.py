"""End-to-end segmentor (port of ``spike2former_tpu/models/segmentor.py``):
backbone -> MaskFormer head -> semantic logits."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.resize import resize_bilinear_hw
from .layers import set_packed_residuals
from .maskformer_head import MaskFormerHead, semantic_inference
from .sdtv2 import SpikingMetaFormer

# ImageNet RGB normalization of every shipped config
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def preprocess(images_u8: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
               std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """[B, H, W, 3] uint8/float RGB -> normalized float32."""
    mean = torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(std, dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() - mean) / std


class Spike2Former(nn.Module):
    """Spiking MaskFormer segmentor: an SDTv2, SDTv3 or SDTv3-MAE backbone
    (``variant``) + the DCN MaskFormer head."""

    def __init__(self, num_classes: int = 150,
                 embed_dim: Sequence[int] = (64, 128, 256, 360),
                 backbone_heads: int = 8, T: int = 4,
                 feat_channels: int = 256, num_queries: int = 100,
                 num_decoder_layers: int = 6, num_encoder_layers: int = 6,
                 depths_stage3: int = 6, depths_stage4: int = 2,
                 dcn_group: int = 32, compat: bool = False,
                 norm_eval: bool = True, collapse_t: bool = True,
                 eval_last_only: bool = True, lazy_masks: bool = False,
                 remat: bool = False, dtype: torch.dtype = torch.float32,
                 packed_residuals: bool = False, variant: str = "sdtv2"):
        super().__init__()
        e = tuple(embed_dim)
        self.dtype = dtype
        self.backbone = SpikingMetaFormer(
            e, num_heads=backbone_heads, T=T, depths_stage3=depths_stage3,
            depths_stage4=depths_stage4, collapse_t=collapse_t,
            norm_eval=norm_eval, remat=remat, dtype=dtype, variant=variant)
        # the MAE flavour's deepest level stays at embed_dim[2]
        last_c = e[2] if variant == "sdtv3mae" else e[3]
        self.head = MaskFormerHead(
            in_channels=(e[0] // 2, e[0], e[1], last_c),
            feat_channels=feat_channels, out_channels=feat_channels,
            num_classes=num_classes, num_queries=num_queries,
            num_decoder_layers=num_decoder_layers,
            num_encoder_layers=num_encoder_layers,
            dcn_group=min(dcn_group, feat_channels),
            eval_last_only=eval_last_only, lazy_masks=lazy_masks,
            compat=compat, remat=remat, dtype=dtype)
        set_packed_residuals(self, packed_residuals)

    def forward(self, images: torch.Tensor,
                valid_hw: torch.Tensor | None = None):
        """images [B, H, W, 3] normalized -> (cls [L, B, nq, ncls+1],
        masks [L, B, nq, H/2, W/2]): L = 1 in eval mode, every decoder
        layer plus the initial queries in training mode (``model.train()``,
        with the backbone's BNs frozen under ``norm_eval``), where
        ``lazy_masks`` returns the masks as ``LazyMasks``.  ``valid_hw``
        [B, 2]: the valid extents of bucket-padded inputs (see
        ``MaskFormerHead``)."""
        return self.head(self.backbone(images), valid_hw=valid_hw)

    def predict_logits(self, images: torch.Tensor,
                       valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """Whole-image semantic logits at input resolution [B, H, W, ncls],
        in the model's dtype: the upsample and the semantic einsum run in
        it, as JAX's ``predict_logits`` (segmentor.py:118-123)."""
        cls_scores, mask_preds = self(images, valid_hw)
        mask = resize_bilinear_hw(mask_preds[-1].to(self.dtype),
                                  tuple(images.shape[1:3]))
        return semantic_inference(cls_scores[-1], mask, self.dtype)
