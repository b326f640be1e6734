"""Whole-image and sliding-window inference, the panoptic merge of a
whole image, and the post-processing (port of
``spike2former_tpu/engine/inference.py``: ``whole_logits``,
``whole_panoptic``, ``bucket_hw``, ``slide_logits``,
``postprocess_pred``).

Reference: mmseg/models/segmentors/encoder_decoder.py ``whole_inference``
(:299-319) and ``slide_inference`` (:246-297), and
``BaseSegmentor.postprocess_result`` (base.py:127-200).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import f32_precision
from ..evaluation.tta import panoptic_inference
from ..models.segmentor import preprocess
from ..ops.resize import resize_bilinear, resize_bilinear_hw
from ..parallel import spatial


@torch.inference_mode()
def whole_logits(model: nn.Module, images_u8: torch.Tensor,
                 valid_hw=None) -> torch.Tensor:
    """[B, H, W, 3] uint8 RGB on the model's device -> [B, H, W, ncls]
    by the model's ``predict_logits`` (any kind).

    ``valid_hw`` ([B, 2] ints) marks the valid region of bucket-padded
    inputs: the MaskFormer masks the padded tokens in its decoder (see
    ``MaskFormerHead``); the FPN family ignores it."""
    if valid_hw is not None:
        valid_hw = torch.as_tensor(valid_hw, dtype=torch.long,
                                   device=images_u8.device)
    return model.predict_logits(preprocess(images_u8), valid_hw)


@torch.inference_mode()
def whole_panoptic(model: nn.Module, images_u8: torch.Tensor,
                   num_things: int = 80, object_mask_thr: float = 0.8
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] RGB (uint8 or float) on the model's device -> (sem
    [B, H, W] int32 with -1 void, inst [B, H, W] int32) by
    ``panoptic_inference`` on the last layer's class scores and its mask
    logits resized bilinearly to the input, all in full float32
    (``f32_precision``).  As in the JAX package no ``valid_hw`` is passed:
    the padding of a bucketed input takes part in the forward as image
    content.  Inside ``parallel.spatial_sharding()`` ``images_u8`` is this
    rank's row band (``shard_rows``), as for ``predict_logits``, and so
    are ``sem`` and ``inst``: the merge is per pixel, on the band's
    upsampled mask logits, and ``gather_rows_h`` joins the maps."""
    with f32_precision():
        cls_scores, mask_preds = model(preprocess(images_u8))
        mask = resize_bilinear_hw(mask_preds[-1].float(),
                                  tuple(images_u8.shape[1:3]))
        return panoptic_inference(cls_scores[-1], mask,
                                  object_mask_thr=object_mask_thr,
                                  num_things=num_things)


def bucket_hw(h: int, w: int, multiple: int = 128) -> tuple[int, int]:
    """Round spatial dims up to a bucket shape, so keep-ratio eval images
    share a few shapes instead of one per distinct (H, W)."""
    return (-(-h // multiple) * multiple, -(-w // multiple) * multiple)


def slide_origins(h: int, w: int, crop: tuple[int, int],
                  stride: tuple[int, int]) -> list[tuple[int, int]]:
    """Top-left corners of the sliding windows (encoder_decoder.py:
    steps of ``stride``, the last window of each axis clamped to the
    image's edge), row-major."""
    ch, cw = crop
    sh, sw = stride
    h_grids = max(h - ch + sh - 1, 0) // sh + 1
    w_grids = max(w - cw + sw - 1, 0) // sw + 1
    return [(min(hi * sh, max(h - ch, 0)), min(wi * sw, max(w - cw, 0)))
            for hi in range(h_grids) for wi in range(w_grids)]


@torch.inference_mode()
def slide_logits(model: nn.Module, images_u8: torch.Tensor,
                 crop_size: tuple[int, int], stride: tuple[int, int],
                 num_classes: int, window_batch: int | None = None
                 ) -> torch.Tensor:
    """Sliding-window logits with overlap averaging: [B, H, W, 3] uint8
    RGB -> [B, H, W, num_classes] f32.

    The windows of every image are stacked (window-major, as the JAX
    package stacks them) and run as batched forwards of ``window_batch``
    crops, by default about eight 512x512 equivalents; the logits are
    summed in f32 and divided by each pixel's window count."""
    spatial.refuse("slide inference")
    b, h, w, _ = images_u8.shape
    ch, cw = min(crop_size[0], h), min(crop_size[1], w)
    x = preprocess(images_u8)
    origins = slide_origins(h, w, (ch, cw), stride)
    crops = torch.cat([x[:, y:y + ch, x0:x0 + cw] for y, x0 in origins])
    wb = window_batch or b * max(1, (8 * 512 * 512) // (ch * cw))
    logits = torch.cat([model.predict_logits(crops[i:i + wb])
                        for i in range(0, len(crops), wb)])
    preds = torch.zeros((b, h, w, num_classes), device=x.device)
    count = torch.zeros((1, h, w, 1), device=x.device)
    for k, (y, x0) in enumerate(origins):
        preds[:, y:y + ch, x0:x0 + cw] += logits[k * b:(k + 1) * b].float()
        count[:, y:y + ch, x0:x0 + cw] += 1.0
    return preds / count.clamp(min=1.0)


def postprocess_pred(logits: torch.Tensor, pad_shape: tuple[int, int] | None,
                     ori_shape: tuple[int, int], flip: bool = False
                     ) -> torch.Tensor:
    """Crop padding, un-flip, resize to the original shape, argmax
    (base.py:127-200): [B, H, W, C] -> [B, oh, ow] int32."""
    if pad_shape is not None:
        logits = logits[:, :pad_shape[0], :pad_shape[1]]
    if flip:
        logits = logits.flip(2)
    if tuple(logits.shape[1:3]) != tuple(ori_shape):
        logits = resize_bilinear(logits, tuple(ori_shape))
    return logits.argmax(-1).to(torch.int32)
