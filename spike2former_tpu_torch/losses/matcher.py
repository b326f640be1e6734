"""Hungarian matching with mask-classification costs (port of
``spike2former_tpu/losses/matcher.py``).

The costs are computed on the device, batched over a leading axis, over a
padded GT axis: invalid GT columns get ``BIG_COST``, which cannot change
the optimum restricted to the valid columns.  Two assignment backends:

* ``hungarian_host``: the exact ``scipy.optimize.linear_sum_assignment``
  on the host, one round trip for the whole batch;
* ``auction_match``: the on-device forward auction, in plain torch ops on
  the costs' device; the costs never leave it.
"""
from __future__ import annotations

from typing import NamedTuple

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
    as the reference's ``log(p + eps)`` does.  They run in the logits'
    dtype when it is float32 or bfloat16 (JAX matcher.py:56-60)."""
    x = (mask_pred if mask_pred.dtype in (torch.float32, torch.bfloat16)
         else mask_pred.float())
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


def focal_mask_cost(mask_pred: torch.Tensor, gt_masks: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0,
                    eps: float = 1e-12) -> torch.Tensor:
    """The sigmoid-focal mask cost: ``mask_cost_terms``' positive and
    negative terms contracted with the GT masks and their complement, over
    the pixel count.  mask_pred [nq, H, W] logits, gt_masks [G, H, W]
    {0, 1} -> [nq, G]; the products take the logits' dtype and sum in
    float32 (JAX matcher.py:75-92)."""
    _, pos, neg = mask_cost_terms(mask_pred.reshape(mask_pred.shape[0], -1),
                                  alpha, gamma, eps)
    ct = pos.dtype
    g = gt_masks.reshape(gt_masks.shape[0], -1).to(ct)
    return ((pos.float() @ g.float().T) + (neg.float() @ (1 - g).float().T)
            ) / pos.shape[1]


def dice_mask_cost(mask_pred: torch.Tensor, gt_masks: torch.Tensor,
                   eps: float = 1.0) -> torch.Tensor:
    """The soft-dice cost of the sigmoided masks: [nq, H, W] x [G, H, W]
    -> [nq, G] (JAX matcher.py:95-106)."""
    nq = mask_pred.shape[0]
    p = torch.sigmoid(mask_pred.float().reshape(nq, -1))
    ct = (mask_pred.dtype if mask_pred.dtype in (torch.float32,
                                                  torch.bfloat16)
          else torch.float32)
    g = gt_masks.reshape(gt_masks.shape[0], -1).to(ct)
    num = 2 * (p.to(ct).float() @ g.float().T)
    den = p.sum(1)[:, None] + g.float().sum(1)[None, :]
    return 1.0 - (num + eps) / (den + eps)


def match_costs(cls_logits: torch.Tensor, mask_pred: torch.Tensor,
                gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                gt_valid: torch.Tensor, cls_weight: float = 1.0,
                focal_weight: float = 20.0, dice_weight: float = 1.0
                ) -> torch.Tensor:
    """Weighted cost matrices [..., nq, G]: cls_logits [..., nq, K+1];
    mask_pred [..., nq, P] logits over a flat pixel axis; gt_labels and
    gt_valid [..., G]; gt_masks [..., G, P] {0, 1}.  Invalid GT columns
    are set to ``BIG_COST``.  The contractions take their operands in the
    logits' dtype and sum in f32 (JAX matcher.py:123-135)."""
    p, pos, neg = mask_cost_terms(mask_pred)
    ct = p.dtype
    g = gt_masks.to(ct).float()
    gt_ = g.transpose(-1, -2)
    n = p.shape[-1]
    focal = (pos.float() @ gt_
             + neg.float() @ (1.0 - g).to(ct).float().transpose(-1, -2)) / n
    num = 2 * (p.float() @ gt_)
    den = (p.float().sum(-1)[..., :, None]
           + g.sum(-1)[..., None, :])
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


class AuctionStats(NamedTuple):
    """What one ``auction_match`` call did."""

    repaired: torch.Tensor    # valid columns the capped auction left
    #                           unmatched and the greedy repair filled
    iterations: torch.Tensor  # auction iterations with a column unassigned
    syncs: int                # host reads of the loop condition


def _greedy_repair(benefit: torch.Tensor, matched: torch.Tensor,
                   invalid_col: torch.Tensor) -> torch.Tensor:
    """Complete a partial assignment: every valid but unmatched GT column
    takes its best still-free query, sequentially over columns (first
    column first, lowest query index on a tie).  Already-matched columns
    are untouched, so where the cap did not bind this is the identity."""
    b, nq, g = benefit.shape
    rows = torch.arange(b, device=benefit.device)
    owned = torch.zeros((b, nq + 1), dtype=torch.bool, device=benefit.device)
    owned = owned.scatter_(1, torch.where(matched >= 0, matched, nq),
                           True)[:, :nq].clone()
    matched = matched.clone()
    for j in range(g):
        need = (matched[:, j] < 0) & ~invalid_col[:, j]
        val = benefit[:, :, j].masked_fill(owned, float("-inf"))
        q = val.argmax(1)
        matched[:, j] = torch.where(need, q, matched[:, j])
        owned[rows, q] |= need
    return matched


# the auction's iterations between host reads of its loop condition: the
# first chunk, doubled after each read up to the second
CHUNKS = (4, 16)


def auction_match(costs: torch.Tensor, num_iters: int = 600,
                  eps: float = 0.02, repair: bool = True,
                  with_stats: bool = False):
    """On-device auction assignment: costs [B, nq, G] -> the query matched
    to each GT column [B, G] (int64, -1 for invalid columns), computed on
    the costs' device.

    The same synchronous-Jacobi forward auction as the JAX package's, step
    for step: GT columns bid for query rows with benefit ``-cost`` from
    zero prices; each unassigned column bids ``top - second + eps`` on its
    best query (``second = top`` where no second exists); each query takes
    its highest bid (first column on a tie), raises its price by it and
    changes owner; invalid (``BIG_COST``) columns are parked as assigned
    and come back -1.  Every step is a max, an argmax (the first maximal
    index, as ``jnp.argmax``), an add or a compare in f32, so on the same
    costs the assignment is identical to JAX's.  The result is within
    ``G_valid * eps`` of the optimum.

    JAX runs the loop as a ``lax.while_loop`` that tests ``~all(assigned)``
    on the device.  Here the host reads that condition only between chunks
    of iterations, ``CHUNKS[0]`` first and doubled after each read up to
    ``CHUNKS[1]`` (``stats.syncs`` reads in all): an
    iteration taken after every column is assigned is a no-op (every bid
    is ``-inf``, so no price or owner changes), so the chunks change no
    number.  The cap still stops the loop after exactly ``num_iters``
    iterations.  A run the cap stopped with valid columns unassigned is
    completed by ``_greedy_repair`` (``repair=True``), and
    ``stats.repaired`` counts those columns.

    ``with_stats`` returns ``(matched, AuctionStats)``."""
    b, nq, g = costs.shape
    dev = costs.device
    neg_inf = float("-inf")
    benefit = -costs.float()
    invalid_col = (costs >= BIG_COST * 0.5).all(1)             # [B, G]
    price = torch.zeros((b, nq), device=dev)
    owner = torch.full((b, nq), -1, dtype=torch.long, device=dev)
    assigned = invalid_col.clone()
    live = torch.zeros((), dtype=torch.long, device=dev)
    first, most = CHUNKS
    syncs, done, it, chunk = 0, False, 0, first
    while it < num_iters:
        for _ in range(min(chunk, num_iters - it)):
            live += ~assigned.all()
            value = benefit - price[:, :, None]                # [B, nq, G]
            top, best_q = value.max(1)                         # [B, G]
            second = value.scatter(1, best_q[:, None], neg_inf).amax(1)
            second = torch.where(second.isfinite(), second, top)
            bid = (top - second + eps).masked_fill(assigned, neg_inf)
            # the highest bid for each query wins (a scatter-max)
            bid_mat = torch.full((b, nq, g), neg_inf, device=dev).scatter_(
                1, best_q[:, None], bid[:, None])
            win_bid, win_gt = bid_mat.max(2)                   # [B, nq]
            got = win_bid > neg_inf
            price = torch.where(got, price + win_bid, price)
            owner = torch.where(got, win_gt, owner)
            # a re-won query's previous owner becomes unassigned
            owns = torch.zeros((b, g + 1), dtype=torch.bool, device=dev)
            owns.scatter_(1, torch.where(owner >= 0, owner, g), True)
            assigned = owns[:, :g] | invalid_col
        it += min(chunk, num_iters - it)
        chunk = min(2 * chunk, most)
        syncs += 1
        if bool(assigned.all()):
            done = True
            break
    # owner [B, nq] -> the matched query of each column [B, G]; a column
    # owns at most one query (it bids only while it owns none), and the
    # unowned queries write to a dropped column
    q_idx = torch.arange(nq, device=dev).expand(b, nq)
    matched = torch.full((b, g + 1), -1, dtype=torch.long, device=dev)
    matched.scatter_(1, torch.where(owner >= 0, owner, g), q_idx)
    raw = matched[:, :g].masked_fill(invalid_col, -1)
    # a run that ended with every column assigned needs no repair
    out = raw if done or not repair else _greedy_repair(benefit, raw,
                                                        invalid_col)
    if with_stats:
        return out, AuctionStats(((raw < 0) & ~invalid_col).sum(), live,
                                 syncs)
    return out
