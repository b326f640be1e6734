"""Test-time augmentation (port of ``tta_logits`` of
``spike2former_tpu/evaluation/tta.py``; mmseg's SegTTAModel,
seg_tta.py:13): logits averaged over a horizontal flip and several
scales, each resized back to the input resolution."""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.resize import resize_bilinear


def tta_logits(predict_fn: Callable[[torch.Tensor], torch.Tensor],
               images: torch.Tensor, scales: Sequence[float] = (1.0,),
               flip: bool = True) -> torch.Tensor:
    """predict_fn: [B, H, W, 3] -> [B, h, w, K] logits at its input's size.
    Returns the mean over every scale (the images resized bilinearly to
    ``round(H * s), round(W * s)``), with and without a horizontal flip,
    of the logits (un-flipped, and resized back to [H, W])."""
    _, h, w, _ = images.shape
    acc, n = None, 0
    for s in scales:
        sh, sw = int(round(h * s)), int(round(w * s))
        x = images if (sh, sw) == (h, w) else resize_bilinear(images,
                                                               (sh, sw))
        for flipped in (False, True) if flip else (False,):
            logits = predict_fn(x.flip(2) if flipped else x)
            if flipped:
                logits = logits.flip(2)
            if tuple(logits.shape[1:3]) != (h, w):
                logits = resize_bilinear(logits, (h, w))
            acc = logits if acc is None else acc + logits
            n += 1
    return acc / n
