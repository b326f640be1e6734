"""MaskFormer training criterion (port of
``spike2former_tpu/losses/criterion.py``): Hungarian-matched CE + focal +
dice, deep-supervised over every decoder layer and the initial queries.

Semantic GT is carried as a ``slot_map`` (pixel -> slot, G = no slot),
since per-class masks are disjoint.  The port computes the function, not
the TPU layout: at ``loss_at='gt'`` it upsamples each layer's matched
predictions densely with ``ops/resize.py`` where the JAX package splits the
upsample into polyphase grids (``_gt_phase_losses``) only to keep the
stack out of TPU memory.  Each layer's loss is recomputed in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint(layer_fn)`` does), so one
layer's ``[B, G, H, W]`` buffers are alive at a time.

``compact_gt`` truncates the GT axis for the auction matcher only, as in
the JAX package; under the host matcher the GT axis stays at the full
``max_gt`` width.

``num_points > 0`` is the point-sampled Mask2Former recipe
(``losses/point_sample.py``): the matching costs of each layer on one
shared uniform point set per image, and the mask losses of each matched
pair on ``num_points`` uncertainty-importance points, where the JAX
package draws its coordinates from ``jax.random`` keys and the port from
a ``Draw`` (a seeded ``torch.Generator`` in training; the JAX draws in the
parity tests).

The losses take float32 logits: a bf16 model's mask logits are float32
sums of its bf16 mask features (``LazyMasks``), and its class scores are
float32.  The matching costs of such a model see its mask logits rounded
to bf16, and run their elementwise terms in bf16, as the JAX package's do
(criterion.py:635-639, matcher.py:56-60).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.resize import resize_bilinear_hw, resize_nearest_torch
from .losses import dice_loss, sigmoid_focal_loss, weighted_cross_entropy
from .matcher import auction_match, hungarian_host, match_costs
from .point_sample import (Draw, point_sample, point_sample_shared,
                           point_sample_slot, uncertain_point_coords)


class LazyMasks(NamedTuple):
    """Deep-supervision mask predictions in factored form: the dense
    per-layer logits are ``einsum('tbqc,tbhwc->bqhw', embeds[l], feats) /
    T``; the loss contracts one layer, and only its matched slots, at a
    time.  The logits are float32 sums of the operands' values
    (``preferred_element_type=float32``), whatever their dtype."""

    embeds: torch.Tensor  # [L, T, B, nq, C] post-SDME mask embeddings
    feats: torch.Tensor   # [T, B, h, w, C] mask features

    @property
    def mask_hw(self) -> tuple[int, int]:
        return self.feats.shape[2], self.feats.shape[3]

    def layer(self, embeds_l: torch.Tensor) -> torch.Tensor:
        """Dense [B, nq, h, w] logits of one layer's embeddings."""
        return torch.einsum("tbqc,tbhwc->bqhw", embeds_l.float(),
                            self.feats.float()) / self.feats.shape[0]

    def layer_flat(self, embeds_l: torch.Tensor) -> torch.Tensor:
        """[B, nq, h*w] logits of one layer, flat pixel axis."""
        t, b, h, w, c = self.feats.shape
        return torch.einsum("tbqc,tbpc->bqp", embeds_l.float(),
                            self.feats.reshape(t, b, h * w, c).float()) / t

    def layer_slots(self, embeds_l: torch.Tensor, q_idx: torch.Tensor
                    ) -> torch.Tensor:
        """Dense [B, G, h, w] logits of the ``q_idx`` [B, G] queries."""
        return slot_logits(embeds_l, self.feats, q_idx)


def slot_logits(embeds_l: torch.Tensor, feats: torch.Tensor,
                q_idx: torch.Tensor) -> torch.Tensor:
    """[T, B, nq, C] embeddings x [T, B, h, w, C] features -> [B, G, h, w]
    logits of the ``q_idx`` [B, G] queries only."""
    t, b, _, c = embeds_l.shape
    idx = q_idx[None, :, :, None].expand(t, b, q_idx.shape[1], c)
    emb = embeds_l.gather(2, idx)  # [T, B, G, C]
    return torch.einsum("tbgc,tbhwc->bghw", emb.float(), feats.float()) / t


class GroundTruth(NamedTuple):
    """Padded mask-classification targets in slot form."""

    labels: torch.Tensor    # [B, G] class id (arbitrary where invalid)
    valid: torch.Tensor     # [B, G] bool
    dropped: torch.Tensor   # [B] present classes beyond G, left out
    slot_map: torch.Tensor  # [B, H, W] pixel -> slot in [0, G]

    def dense_masks(self) -> torch.Tensor:
        """Dense bool masks [B, G, H, W]."""
        return slot_masks(self.slot_map, self.labels.shape[1])

    @property
    def gt_hw(self) -> tuple[int, int]:
        return self.slot_map.shape[-2], self.slot_map.shape[-1]


def slot_masks(slot_map: torch.Tensor, g: int) -> torch.Tensor:
    """[B, H, W] slot map -> [B, G, H, W] bool masks of slots 0..G-1."""
    slots = torch.arange(g, device=slot_map.device)
    return slot_map[:, None] == slots[None, :, None, None]


def slot_map_from_masks(masks: torch.Tensor, valid: torch.Tensor
                        ) -> torch.Tensor:
    """[B, G, H, W] disjoint {0,1} masks and [B, G] validity -> [B, H, W]
    slot map (G where no valid slot covers the pixel; the first slot wins
    where masks overlap), as JAX's ``slot_map_from_masks``."""
    g = masks.shape[1]
    m = masks.bool() & valid[:, :, None, None].bool()
    # torch.argmax takes no bool; on 0/1 it returns the first maximum
    first = m.to(torch.uint8).argmax(1)
    return torch.where(m.any(1), first, g)


def semantic_to_instances(sem_seg: torch.Tensor, num_classes: int,
                          max_gt: int) -> GroundTruth:
    """Per-class targets from a semantic map [B, H, W] (the mmseg shim's
    ``_seg_data_to_instance_data``): the present class ids, in increasing
    order, take the first of ``min(max_gt, num_classes)`` slots, then the
    absent ones in increasing order (invalid).  Pixels outside
    ``[0, num_classes)`` (ignore 255) and classes beyond the slots get no
    slot; the latter are counted in ``dropped``."""
    b = sem_seg.shape[0]
    dev = sem_seg.device
    flat = sem_seg.reshape(b, -1).long()
    cls = torch.where((flat >= 0) & (flat < num_classes), flat, num_classes)
    present = torch.zeros((b, num_classes + 1), dtype=torch.bool, device=dev)
    present.scatter_(1, cls, True)
    present = present[:, :num_classes]
    k = min(max_gt, num_classes)
    ids = torch.arange(num_classes, device=dev)
    order = torch.where(present, ids, ids + num_classes)
    sel = order.argsort(1)[:, :k]                       # [B, k]
    valid = present.gather(1, sel)
    # class -> slot table; absent, unselected and ignored classes -> k
    table = torch.full((b, num_classes + 1), k, dtype=torch.long, device=dev)
    slot_ids = torch.arange(k, device=dev).expand(b, k)
    table.scatter_(1, torch.where(valid, sel, num_classes), slot_ids)
    table[:, num_classes] = k
    slot_map = table.gather(1, cls).reshape(sem_seg.shape)
    return GroundTruth(labels=sel, valid=valid,
                       dropped=present.sum(1) - valid.sum(1),
                       slot_map=slot_map)


def classification_targets(matched_q: torch.Tensor, gt_labels: torch.Tensor,
                           nq: int, num_classes: int) -> torch.Tensor:
    """Per-query class targets [B, nq]: a matched query gets its GT label,
    every other query background (``num_classes``).  Unmatched or padded
    GT rows (``matched_q < 0``) write to a dropped column."""
    b = matched_q.shape[0]
    out = torch.full((b, nq + 1), num_classes, dtype=torch.long,
                     device=matched_q.device)
    out.scatter_(1, torch.where(matched_q >= 0, matched_q, nq),
                 gt_labels.long())
    return out[:, :nq]


def _layer_loss(cls_scores, pred_at_gt, matched_q, gt: GroundTruth,
                slot_ds, draws=None, *, num_classes: int, class_weight,
                focal_weight: float, dice_weight: float, num_total_masks,
                loss_at: str, point_cfg: tuple | None = None):
    """Losses of one decoder layer, given its assignment.

    cls_scores [B, nq, K+1]; pred_at_gt [B, G, h, w] logits of the query
    matched to each GT slot; matched_q [B, G] (-1 = unmatched);
    slot_ds [B, h, w] the slot map nearest-downsampled to mask resolution.
    ``loss_at='gt'`` upsamples the predictions bilinearly to GT resolution
    (the reference, maskformer_head.py:475-479); ``'pred'`` takes the
    downsampled GT instead.

    ``point_cfg = (num_points, oversample, importance, dtype)`` takes the
    mask losses on each pair's uncertainty-importance points instead
    (mask2former_track_head.py:405-436; JAX criterion.py:376-405), made
    from ``draws`` (the oversampled and the fresh uniforms, drawn before
    the call so that the backward's recomputation sees the same): the
    ranking and the GT targets at bfloat16, the predictions at ``dtype``;
    dice over the points with ``avg_factor = num_total_masks`` and focal
    with ``num_total_masks * num_points``."""
    b, nq = cls_scores.shape[:2]
    g = gt.labels.shape[1]
    labels = classification_targets(matched_q, gt.labels, nq, num_classes)
    loss_cls = weighted_cross_entropy(
        cls_scores.reshape(b * nq, -1), labels.reshape(-1), class_weight)
    pair_w = (gt.valid & (matched_q >= 0)).float()       # [B, G]
    if point_cfg is not None:
        n_pts, osr, imp, pdt = point_cfg
        queue = list(draws)
        coords = uncertain_point_coords(
            pred_at_gt.float(), n_pts, osr, imp,
            draw=lambda shape: queue.pop(0), dtype=torch.bfloat16)
        pred_pts = point_sample(pred_at_gt, coords, dtype=pdt)  # [B, G, P]
        tgt_pts = point_sample_slot(gt.slot_map, g, coords,
                                    dtype=torch.bfloat16)
        loss_dice = dice_loss(
            pred_pts.reshape(b * g, n_pts), tgt_pts.reshape(b * g, n_pts),
            weight=pair_w.reshape(-1), eps=1.0, naive=True, activate=True,
            avg_factor=num_total_masks)
        loss_focal = sigmoid_focal_loss(
            pred_pts, tgt_pts, weight=pair_w[..., None],
            avg_factor=num_total_masks * n_pts)
        return (loss_cls, loss_focal * focal_weight, loss_dice * dice_weight)
    if loss_at == "gt":
        gh, gw = gt.gt_hw
        pred_m = resize_bilinear_hw(pred_at_gt, (gh, gw))
        tgt_m = slot_masks(gt.slot_map, g)
    else:
        gh, gw = pred_at_gt.shape[-2:]
        pred_m = pred_at_gt
        tgt_m = slot_masks(slot_ds, g)
    loss_dice = dice_loss(
        pred_m.reshape(b * g, gh, gw), tgt_m.reshape(b * g, gh, gw),
        weight=pair_w.reshape(-1), eps=1.0, naive=True, activate=True,
        avg_factor=num_total_masks)
    # The reference passes ``1 - mask_targets`` to mmdet's FocalLoss, which
    # one-hots it as a class index: the effective float target is the mask.
    loss_focal = sigmoid_focal_loss(
        pred_m, tgt_m, weight=pair_w[..., None, None],
        avg_factor=num_total_masks * gh * gw)
    return (loss_cls, loss_focal * focal_weight, loss_dice * dice_weight)


def _lazy_layer_loss(cls_scores, embeds_l, feats, matched_q, gt, slot_ds,
                     draws=None, **kw):
    safe_q = torch.where(matched_q >= 0, matched_q, 0)
    return _layer_loss(cls_scores, slot_logits(embeds_l, feats, safe_q),
                       matched_q, gt, slot_ds, draws, **kw)


def _dense_layer_loss(cls_scores, masks_l, matched_q, gt, slot_ds,
                      draws=None, **kw):
    safe_q = torch.where(matched_q >= 0, matched_q, 0)
    idx = safe_q[:, :, None, None].expand(-1, -1, *masks_l.shape[-2:])
    return _layer_loss(cls_scores, masks_l.gather(1, idx), matched_q, gt,
                       slot_ds, draws, **kw)


@torch.no_grad()
def match_all_layers(all_cls_scores: torch.Tensor, all_mask_preds,
                     gt: GroundTruth, slot_ds: torch.Tensor | None, *,
                     matcher: str = "host", focal_weight: float = 20.0,
                     dice_weight: float = 1.0,
                     point_coords: list[torch.Tensor] | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The assignment of every layer in ONE matcher call over the L*B cost
    matrices (one host round trip for ``'host'``, one auction for
    ``'auction'``): [L, B, G] query per GT slot, -1 where the slot is
    invalid or unmatched, and the number of columns the auction's greedy
    repair filled (0 for the host matcher, which always completes).
    Costs are taken at mask resolution against the nearest-downsampled
    GT, or with ``point_coords`` (one [B, P, 2] point set per layer) on
    the predictions and GT sampled at those points
    (mask2former_track_head.py:300-319; JAX criterion.py:600-625)."""
    num_layers, b = all_cls_scores.shape[:2]
    g = gt.labels.shape[1]
    lazy = isinstance(all_mask_preds, LazyMasks)
    if point_coords is None:
        gt_cost = slot_masks(slot_ds, g).reshape(b, g, -1).float()
    costs = []
    for li in range(num_layers):
        if point_coords is not None:
            mask_l = (all_mask_preds.layer(all_mask_preds.embeds[li])
                      if lazy else all_mask_preds[li])
            pts = point_coords[li]
            costs.append(match_costs(
                all_cls_scores[li], point_sample_shared(mask_l, pts),
                gt.labels, point_sample_slot(gt.slot_map, g, pts), gt.valid,
                focal_weight=focal_weight, dice_weight=dice_weight))
            continue
        if lazy:
            # a bf16 model's costs take bf16 logits (JAX criterion.py:638)
            mask_l = all_mask_preds.layer_flat(
                all_mask_preds.embeds[li]).to(all_mask_preds.feats.dtype)
        else:
            mask_l = all_mask_preds[li].reshape(b, all_mask_preds.shape[2],
                                                -1)
        costs.append(match_costs(
            all_cls_scores[li], mask_l, gt.labels, gt_cost, gt.valid,
            focal_weight=focal_weight, dice_weight=dice_weight))
    costs = torch.stack(costs).reshape(num_layers * b, -1, g)
    if matcher == "host":
        matched = hungarian_host(costs)
        repaired = torch.zeros((), dtype=torch.long, device=costs.device)
    else:
        matched, stats = auction_match(costs, with_stats=True)
        repaired = stats.repaired
    matched = matched.reshape(num_layers, b, g)
    return torch.where(gt.valid[None], matched, -1), repaired


def maskformer_loss(all_cls_scores: torch.Tensor, all_mask_preds,
                    gt: GroundTruth, *, num_classes: int,
                    bg_class_weight: float = 0.1, focal_weight: float = 20.0,
                    dice_weight: float = 1.0, matcher: str = "host",
                    loss_at: str = "pred", compact_gt: int | None = None,
                    num_points: int = 0, oversample_ratio: float = 3.0,
                    importance_sample_ratio: float = 0.75,
                    points_dtype: torch.dtype = torch.float32,
                    draw: Draw | None = None) -> dict[str, torch.Tensor]:
    """Deep-supervised loss over all L layers (loss_by_feat :367-408).

    all_cls_scores [L, B, nq, K+1]; all_mask_preds dense [L, B, nq, h, w]
    or ``LazyMasks``.  Returns ``{loss_cls, loss_mask, loss_dice}`` of the
    last layer, ``d{i}.loss_*`` of the others (the reference's logger
    keys), ``total`` (their sum) and ``repaired_gt`` (the columns the
    auction's greedy repair filled; 0 for the host matcher).

    ``compact_gt``: the exact fast path of the padded GT axis, for the
    auction matcher only.  ``semantic_to_instances`` packs the valid slots
    into a prefix, so where no slot past ``compact_gt`` is valid the GT
    axis is cut to ``compact_gt`` slots (the slot map through
    ``minimum(slot_map, compact_gt)``) with no change to any number:
    invalid columns carry ``BIG_COST`` and zero pair weight.  Otherwise
    the loss runs at full width.  JAX picks the branch on the device with
    ``lax.cond``; here the overflow test is one host read per call.

    ``num_points > 0`` (``train.loss_points``) takes the matching costs and
    the mask losses on sampled points (the module docstring), with the
    uniforms from ``draw``, in this order: each layer's shared matching
    points [B, P, 2], then for each layer the per-pair oversampled points
    [B, G, P * oversample, 2] and the fresh ones.  ``points_dtype`` is the
    gradient-carrying sampler's (``train.loss_points_dtype``)."""
    if loss_at not in ("pred", "gt"):
        raise ValueError(f"loss_at must be 'pred' or 'gt', got {loss_at!r}")
    if matcher not in ("host", "auction"):
        raise ValueError(
            f"matcher must be 'host' or 'auction', got {matcher!r}")
    if num_points and draw is None:
        raise ValueError("num_points > 0 needs a draw of uniforms")
    gc = compact_gt
    if (gc and gc < gt.labels.shape[1] and matcher != "host"
            and not bool(gt.valid[:, gc:].any())):
        small = GroundTruth(labels=gt.labels[:, :gc], valid=gt.valid[:, :gc],
                            dropped=gt.dropped,
                            slot_map=torch.clamp(gt.slot_map, max=gc))
        return maskformer_loss(
            all_cls_scores, all_mask_preds, small, num_classes=num_classes,
            bg_class_weight=bg_class_weight, focal_weight=focal_weight,
            dice_weight=dice_weight, matcher=matcher, loss_at=loss_at,
            num_points=num_points, oversample_ratio=oversample_ratio,
            importance_sample_ratio=importance_sample_ratio,
            points_dtype=points_dtype, draw=draw)
    dev = all_cls_scores.device
    class_weight = torch.tensor([1.0] * num_classes + [bg_class_weight],
                                device=dev)
    num_total = gt.valid.float().sum().clamp(min=1.0)
    num_layers = all_cls_scores.shape[0]
    lazy = isinstance(all_mask_preds, LazyMasks)
    h, w = (all_mask_preds.mask_hw if lazy else all_mask_preds.shape[-2:])
    b, g = gt.labels.shape
    point_cfg = match_pts = None
    if num_points:
        # the point path samples GT at its own resolution: no slot_ds
        slot_ds = None
        point_cfg = (num_points, oversample_ratio, importance_sample_ratio,
                     points_dtype)
        match_pts = [draw((b, num_points, 2)).to(dev)
                     for _ in range(num_layers)]
        n_imp = int(importance_sample_ratio * num_points)
        shapes = [(b, g, int(num_points * oversample_ratio), 2)]
        if num_points > n_imp:
            shapes.append((b, g, num_points - n_imp, 2))
    else:
        slot_ds = resize_nearest_torch(gt.slot_map[..., None],
                                       (h, w))[..., 0]
    matched, repaired = match_all_layers(
        all_cls_scores, all_mask_preds, gt, slot_ds, matcher=matcher,
        focal_weight=focal_weight, dice_weight=dice_weight,
        point_coords=match_pts)
    kw = dict(num_classes=num_classes, class_weight=class_weight,
              focal_weight=focal_weight, dice_weight=dice_weight,
              num_total_masks=num_total, loss_at=loss_at,
              point_cfg=point_cfg)
    per_layer = []
    for li in range(num_layers):
        draws = ([draw(s).to(dev) for s in shapes] if num_points
                 else None)
        if lazy:
            fn, mask_args = _lazy_layer_loss, (all_mask_preds.embeds[li],
                                               all_mask_preds.feats)
        else:
            fn, mask_args = _dense_layer_loss, (all_mask_preds[li],)
        # recomputed in the backward: one layer's buffers alive at a time
        per_layer.append(checkpoint(
            fn, all_cls_scores[li], *mask_args, matched[li], gt, slot_ds,
            draws, use_reentrant=False, **kw))
    losses: dict[str, torch.Tensor] = {}
    for k, name in enumerate(("loss_cls", "loss_mask", "loss_dice")):
        losses[name] = per_layer[-1][k]
        for i in range(num_layers - 1):
            losses[f"d{i}.{name}"] = per_layer[i][k]
    losses["total"] = sum(torch.stack([layer[k] for layer in per_layer]).sum()
                          for k in range(3))
    losses["repaired_gt"] = repaired.float()
    return losses
