"""The IoU metric (port of ``init_iou``, ``update_iou``, ``update_iou_np``
and ``compute_iou`` of ``spike2former_tpu/evaluation/iou_metric.py``;
reference: mmseg/evaluation/metrics/iou_metric.py:19-286): per-class
intersection, union, prediction and label areas summed over the dataset,
then mIoU, mAcc and aAcc."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class IoUState(NamedTuple):
    intersect: np.ndarray     # [K]
    union: np.ndarray         # [K]
    pred_label: np.ndarray    # [K]
    label: np.ndarray         # [K]


def init_iou(num_classes: int) -> IoUState:
    z = np.zeros((num_classes,), np.float32)
    return IoUState(z, z, z, z)


def update_iou_np(state: IoUState, pred: np.ndarray, label: np.ndarray,
                  num_classes: int, ignore_index: int = 255) -> IoUState:
    """Add one batch: pred and label [B, H, W] int (intersect_and_union,
    iou_metric.py:165-230); pixels labelled ``ignore_index`` are left
    out."""
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1)
    valid = label != ignore_index
    pred, label = pred[valid], label[valid]

    def hist(x):
        return np.bincount(x, minlength=num_classes)[:num_classes]

    area_i = hist(pred[pred == label])
    area_p = hist(pred)
    area_l = hist(label)
    dt = state.intersect.dtype
    return IoUState(
        intersect=state.intersect + area_i.astype(dt),
        union=state.union + (area_p + area_l - area_i).astype(dt),
        pred_label=state.pred_label + area_p.astype(dt),
        label=state.label + area_l.astype(dt))


def update_iou(state: IoUState, pred: torch.Tensor, label: torch.Tensor,
               num_classes: int, ignore_index: int = 255) -> IoUState:
    """``update_iou_np`` on tensors, on their device: pred and label [B,
    H, W] int; the state's fields come back as float32 tensors there
    (``compute_iou`` takes them once they are on the host)."""
    valid = label != ignore_index
    pred = torch.where(valid, pred, num_classes).long()
    label = torch.where(valid, label, num_classes).long()

    def hist(x):
        return torch.bincount(x.reshape(-1), minlength=num_classes + 1
                              )[:num_classes].float()

    area_i = hist(torch.where(pred == label, pred, num_classes))
    area_p, area_l = hist(pred), hist(label)

    def acc(field, add):
        return torch.as_tensor(field, dtype=torch.float32,
                               device=add.device) + add

    return IoUState(intersect=acc(state.intersect, area_i),
                    union=acc(state.union, area_p + area_l - area_i),
                    pred_label=acc(state.pred_label, area_p),
                    label=acc(state.label, area_l))


def compute_iou(state: IoUState) -> dict[str, np.ndarray | float]:
    """Per-class IoU and Acc, and mIoU, mAcc, aAcc in percent; classes
    absent from both prediction and GT (IoU) or from the GT (Acc) are left
    out of the means (iou_metric.py:102-162)."""
    inter = np.asarray(state.intersect, np.float64)
    union = np.asarray(state.union, np.float64)
    label = np.asarray(state.label, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inter / union
        acc = inter / label
    iou[union == 0] = np.nan
    acc[label == 0] = np.nan
    aacc = inter.sum() / max(label.sum(), 1.0)
    return {"IoU": iou, "Acc": acc,
            "mIoU": float(np.nanmean(iou) * 100),
            "mAcc": float(np.nanmean(acc) * 100),
            "aAcc": float(aacc * 100)}
