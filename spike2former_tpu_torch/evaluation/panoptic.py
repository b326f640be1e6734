"""Panoptic Quality (port of ``spike2former_tpu/evaluation/panoptic.py``):
panopticapi's ``PQStat`` protocol as mmdet's ``CocoPanopticMetric`` uses
it, in host numpy, image by image.

Per class, TP/FP/FN with segments matched at IoU > 0.5; the union leaves
out the prediction's overlap with VOID; crowd GT segments are not
matched, and an unmatched prediction that lies mostly on VOID or on a
crowd of its class is no FP.

PQ = sum_TP IoU / (TP + FP/2 + FN/2); SQ = sum IoU / TP; RQ = TP / (...).
"""
from __future__ import annotations

import numpy as np

VOID_LABEL = -1  # the label of void pixels in (label, inst) maps


class PQStat:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.iou = np.zeros(num_classes)
        self.tp = np.zeros(num_classes, np.int64)
        self.fp = np.zeros(num_classes, np.int64)
        self.fn = np.zeros(num_classes, np.int64)


def _combine(label_map: np.ndarray, inst_map: np.ndarray) -> np.ndarray:
    """(label, instance) -> one int64 segment key; void -> -1."""
    comb = label_map.astype(np.int64) * (1 << 24) + \
        (inst_map.astype(np.int64) & ((1 << 24) - 1))
    return np.where(label_map == VOID_LABEL, -1, comb)


def pq_update(stat: PQStat, pred_label: np.ndarray, pred_inst: np.ndarray,
              gt_label: np.ndarray, gt_inst: np.ndarray,
              gt_crowd: np.ndarray | None = None) -> PQStat:
    """Accumulate one image into ``stat`` (and return it).  All maps
    [H, W] int with ``label == -1`` void; ``gt_crowd`` the bool map of
    crowd GT pixels."""
    if gt_crowd is None:
        gt_crowd = np.zeros(gt_label.shape, bool)
    pred_keys, pred_idx, pred_n = np.unique(
        _combine(pred_label, pred_inst), return_inverse=True,
        return_counts=True)
    gt_keys, gt_idx, gt_n = np.unique(
        _combine(gt_label, gt_inst), return_inverse=True, return_counts=True)
    pred_areas = {int(k): int(c) for k, c in zip(pred_keys, pred_n)}
    gt_areas = {int(k): int(c) for k, c in zip(gt_keys, gt_n)}
    crowd_keys = set(int(k) for k in np.unique(
        gt_keys[gt_idx.reshape(gt_label.shape)[gt_crowd]])) - {-1}
    # pairwise intersections, in (pred, gt) order as JAX's 2-D unique
    # gives them: one 1-D unique of pair indices (JAX's ``axis=1`` unique
    # sorts rows of a structured view, several times slower).  IoU > 0.5
    # makes a match unique per segment, so the order (largest
    # intersection first) only fixes determinism
    ng = len(gt_keys)
    pair, counts = np.unique(pred_idx.ravel() * ng + gt_idx.ravel(),
                             return_counts=True)
    inter = {(int(pred_keys[k // ng]), int(gt_keys[k % ng])): int(c)
             for k, c in zip(pair, counts)}

    def label_of(key: int) -> int:
        return key >> 24

    # each prediction's overlap with VOID (the union's correction, FP rule)
    pred_void = {p: c for (p, g), c in inter.items() if g == -1}
    matched_pred: set[int] = set()
    matched_gt: set[int] = set()
    for (pk, gk), i_area in sorted(inter.items(), key=lambda kv: -kv[1]):
        if pk == -1 or gk == -1 or gk in crowd_keys:
            continue
        pl, gl = label_of(pk), label_of(gk)
        if pl != gl or pk in matched_pred or gk in matched_gt:
            continue
        union = (pred_areas[pk] + gt_areas[gk] - i_area
                 - pred_void.get(pk, 0))
        iou = i_area / max(union, 1)
        if iou > 0.5:
            stat.tp[gl] += 1
            stat.iou[gl] += iou
            matched_pred.add(pk)
            matched_gt.add(gk)
    # FN: unmatched GT segments that are neither void nor crowd
    for gk in gt_areas:
        if gk == -1 or gk in crowd_keys or gk in matched_gt:
            continue
        stat.fn[label_of(gk)] += 1
    # FP: unmatched predictions, unless mostly on VOID or same-class crowd
    for pk, area in pred_areas.items():
        if pk == -1 or pk in matched_pred:
            continue
        pl = label_of(pk)
        ignore = pred_void.get(pk, 0)
        for ck in crowd_keys:
            if label_of(ck) == pl:
                ignore += inter.get((pk, ck), 0)
        if ignore / max(area, 1) > 0.5:
            continue
        stat.fp[pl] += 1
    return stat


def compute_pq(stat: PQStat, num_things: int | None = None) -> dict:
    """PQ, SQ and RQ (in %) averaged over the classes present, the per-class
    PQ and, with ``num_things``, PQ over things (``PQ_th``) and stuff
    (``PQ_st``)."""
    denom = stat.tp + stat.fp / 2 + stat.fn / 2
    present = denom > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        pq = np.where(present, stat.iou / np.maximum(denom, 1e-9), np.nan)
        sq = np.where(stat.tp > 0, stat.iou / np.maximum(stat.tp, 1), np.nan)
        rq = np.where(present, stat.tp / np.maximum(denom, 1e-9), np.nan)
    out = {
        "PQ": float(np.nanmean(pq) * 100) if present.any() else 0.0,
        "SQ": float(np.nanmean(sq) * 100) if (stat.tp > 0).any() else 0.0,
        "RQ": float(np.nanmean(rq) * 100) if present.any() else 0.0,
        "per_class_PQ": pq * 100,
    }
    if num_things is not None:
        th, st = pq[:num_things], pq[num_things:]
        out["PQ_th"] = (float(np.nanmean(th) * 100)
                        if np.isfinite(th).any() else float("nan"))
        out["PQ_st"] = (float(np.nanmean(st) * 100)
                        if np.isfinite(st).any() else float("nan"))
    return out
