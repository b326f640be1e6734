"""Test-time augmentation and the panoptic merge (port of ``tta_logits``
and ``panoptic_inference`` of ``spike2former_tpu/evaluation/tta.py``).
``tta_logits`` is mmseg's SegTTAModel (seg_tta.py:13): logits averaged
over a horizontal flip and several scales, each resized back to the
input resolution."""
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


def panoptic_inference(cls_scores: torch.Tensor, mask_preds: torch.Tensor,
                       object_mask_thr: float = 0.8, num_things: int = 80
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mask-classification panoptic merge: each pixel goes to the
    confident query (top class probability above ``object_mask_thr``)
    whose score-weighted mask probability is largest there, and is void
    unless that product exceeds 0.5.

    cls_scores [B, nq, K+1]; mask_preds [B, nq, H, W] logits.  Returns
    (sem [B, H, W] int32, the winner's class or -1, inst [B, H, W] int32,
    the winning query + 1 where its class is a thing, else 0).  Ties go to
    the first class and the first query, as ``jnp.argmax``'s do.  Every
    pixel's answer reads only that pixel's logits, so a row band of
    ``mask_preds`` gives that band of the maps."""
    probs = torch.softmax(cls_scores.float(), -1)[..., :-1]
    labels = probs.argmax(-1)                              # [B, nq]
    scores = probs.gather(-1, labels[..., None])[..., 0]
    keep = scores > object_mask_thr
    weighted = torch.sigmoid(mask_preds.float()) * (
        scores * keep)[..., None, None]
    winner = weighted.argmax(1)                            # [B, H, W]
    win_score = weighted.gather(1, winner[:, None])[:, 0]
    valid = win_score > 0.5
    sem = labels.gather(1, winner.flatten(1)).reshape(winner.shape)
    sem = torch.where(valid, sem, -1)
    inst = torch.where(valid & (sem < num_things), winner + 1, 0)
    return sem.to(torch.int32), inst.to(torch.int32)
