"""Losses for mask-classification training (port of
``spike2former_tpu/losses/losses.py``): class-weighted softmax CE with
background weight 0.1, sigmoid focal loss (alpha 0.25, gamma 2) and naive
dice with eps 1.0, with mmdet's reduction semantics."""
from __future__ import annotations

import torch


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weight: torch.Tensor,
                           sample_weight: torch.Tensor | None = None,
                           avg_factor: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """``F.cross_entropy(weight=class_weight)`` summed over
    ``avg_factor``, by default ``sum(class_weight[labels])``: logits
    [N, K+1], labels [N]."""
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    w = class_weight[labels.long()]
    if sample_weight is not None:
        w = w * sample_weight
    if avg_factor is None:
        avg_factor = w.sum()
    return (nll * w).sum() / avg_factor.clamp(min=1e-12)


def focal_terms(pred: torch.Tensor, target: torch.Tensor,
                gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Per-element sigmoid focal loss terms (py_sigmoid_focal_loss body):
    pred f32 logits, target f32 {0, 1}.  ``exp(-|x|)`` is shared by the
    sigmoid and the stable BCE ``log1p``.

    At ``pred == 0`` the terms take JAX's derivatives: ``|x|`` has slope
    +1 there (``jnp.abs``) and ``max(x, 0)`` splits its slope in half
    (``jnp.maximum``), where ``torch.abs`` and ``torch.clamp`` give 0 and
    1.  The case is real: a query whose mask embedding spikes to all zeros
    has logits of exactly 0."""
    ax = torch.where(pred >= 0, pred, -pred)
    e = torch.exp(-ax)
    p = torch.where(pred >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    pt = (1.0 - p) * target + p * (1.0 - target)
    ptg = pt * pt if gamma == 2.0 else pt ** gamma
    focal_w = (alpha * target + (1.0 - alpha) * (1.0 - target)) * ptg
    bce = (torch.maximum(pred, torch.zeros_like(pred)) - pred * target
           + torch.log1p(e))
    return bce * focal_w


def sigmoid_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                       weight: torch.Tensor | None = None,
                       gamma: float = 2.0, alpha: float = 0.25,
                       avg_factor: torch.Tensor | float | None = None
                       ) -> torch.Tensor:
    """py_sigmoid_focal_loss with mean or ``sum / avg_factor``."""
    loss = focal_terms(pred.float(), target.float(), gamma, alpha)
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor), min=1e-12)


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              weight: torch.Tensor | None = None, eps: float = 1.0,
              naive: bool = True, activate: bool = True,
              avg_factor: torch.Tensor | float | None = None
              ) -> torch.Tensor:
    """dice_loss over [N, ...] logits (or probabilities with
    ``activate=False``) and {0, 1} targets; ``naive`` is the
    ``naive_dice=True`` form the configs select."""
    pred = pred.float()
    if activate:
        pred = torch.sigmoid(pred)
    n = pred.shape[0]
    p = pred.reshape(n, -1)
    t = target.float().reshape(n, -1)
    a = (p * t).sum(1)
    if naive:
        d = (2 * a + eps) / (p.sum(1) + t.sum(1) + eps)
    else:
        d = 2 * a / ((p * p).sum(1) + eps + (t * t).sum(1) + eps)
    loss = 1.0 - d
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor), min=1e-12)
