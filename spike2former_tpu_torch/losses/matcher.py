"""Hungarian matching with mask-classification costs (port of
``match_costs`` and ``hungarian_host`` of
``spike2former_tpu/losses/matcher.py``).

The costs are computed on the device, batched over a leading axis, over a
padded GT axis: invalid GT columns get ``BIG_COST``, which cannot change
the optimum restricted to the valid columns.  The assignment is the exact
``scipy.optimize.linear_sum_assignment`` on the host, one round trip for
the whole batch.  The on-device auction matcher is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

BIG_COST = 1e6


def classification_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor
                        ) -> torch.Tensor:
    """``-softmax(cls)[..., gt_label]``: [..., nq, K+1] x [..., G] ->
    [..., nq, G]."""
    probs = torch.softmax(cls_logits.float(), -1)
    idx = gt_labels.clamp(min=0).long()[..., None, :].expand(
        *probs.shape[:-1], gt_labels.shape[-1])
    return -probs.gather(-1, idx)


def mask_cost_terms(mask_pred: torch.Tensor, alpha: float = 0.25,
                    gamma: float = 2.0, eps: float = 1e-12):
    """(p, pos, neg) per-pixel cost terms of [..., nq, P] logits from one
    ``exp(-|x|)`` and one ``log1p``; the log terms saturate at ``log(eps)``
    as the reference's ``log(p + eps)`` does."""
    x = mask_pred.float()
    e = torch.exp(-x.abs())
    l1p = torch.log1p(e)
    p = torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
    floor = float(np.log(eps))
    nlogp = torch.clamp(l1p - torch.clamp(x, max=0.0), max=-floor)
    nlog1mp = torch.clamp(l1p - torch.clamp(-x, max=0.0), max=-floor)
    q = 1.0 - p
    pg = p * p if gamma == 2.0 else p ** gamma
    qg = q * q if gamma == 2.0 else q ** gamma
    return p, nlogp * (alpha * qg), nlog1mp * ((1.0 - alpha) * pg)


def match_costs(cls_logits: torch.Tensor, mask_pred: torch.Tensor,
                gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                gt_valid: torch.Tensor, cls_weight: float = 1.0,
                focal_weight: float = 20.0, dice_weight: float = 1.0
                ) -> torch.Tensor:
    """Weighted cost matrices [..., nq, G]: cls_logits [..., nq, K+1];
    mask_pred [..., nq, P] logits over a flat pixel axis; gt_labels and
    gt_valid [..., G]; gt_masks [..., G, P] {0, 1}.  Invalid GT columns
    are set to ``BIG_COST``."""
    p, pos, neg = mask_cost_terms(mask_pred)
    g = gt_masks.float()
    gt_ = g.transpose(-1, -2)
    n = p.shape[-1]
    focal = (pos @ gt_ + neg @ (1.0 - g).transpose(-1, -2)) / n
    num = 2 * (p @ gt_)
    den = p.sum(-1)[..., :, None] + g.sum(-1)[..., None, :]
    dice = 1.0 - (num + 1.0) / (den + 1.0)
    cost = (cls_weight * classification_cost(cls_logits, gt_labels)
            + focal_weight * focal + dice_weight * dice)
    return torch.where(gt_valid[..., None, :], cost,
                       torch.full_like(cost, BIG_COST))


def hungarian_host(costs: torch.Tensor) -> torch.Tensor:
    """Exact assignment on the host: costs [B, nq, G] -> the query matched
    to each GT column [B, G] (int64, -1 where no query is left), on the
    costs' device."""
    from scipy.optimize import linear_sum_assignment

    c = costs.detach().float().cpu().numpy()
    out = np.full((c.shape[0], c.shape[2]), -1, np.int64)
    for i in range(c.shape[0]):
        rows, cols = linear_sum_assignment(c[i])
        out[i, cols] = rows
    return torch.from_numpy(out).to(costs.device)
