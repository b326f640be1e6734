"""Cityscapes official pixel-level evaluation protocol, natively (port of
``spike2former_tpu/evaluation/cityscapes_metric.py``).

The reference's CityscapesMetric (mmseg/evaluation/metrics/citys_metric.py:
26-160) writes labelId PNGs and shells out to cityscapesscripts'
``evalPixelLevelSemanticLabeling``.  That package is not a dependency here,
so the protocol core is reimplemented: a confusion matrix over official
labelIds restricted to the 19 ``ignoreInEval=False`` classes, with every
other labelId (void/ignored) excluded from both rows and columns — giving
the same per-class IoU / mIoU ("classes" score) the official script
reports.

The label table below is the public Cityscapes ``labels.py`` constant set
(labelId, name, ignoreInEval).
"""
from __future__ import annotations

import os

import numpy as np

# (labelId, name) of the 19 evaluated classes, in official trainId order
CITYSCAPES_EVAL_LABELS = (
    (7, "road"), (8, "sidewalk"), (11, "building"), (12, "wall"),
    (13, "fence"), (17, "pole"), (19, "traffic light"),
    (20, "traffic sign"), (21, "vegetation"), (22, "terrain"), (23, "sky"),
    (24, "person"), (25, "rider"), (26, "car"), (27, "truck"), (28, "bus"),
    (31, "train"), (32, "motorcycle"), (33, "bicycle"),
)

_LABEL2INDEX = np.full(256, -1, np.int32)
for _i, (_lid, _) in enumerate(CITYSCAPES_EVAL_LABELS):
    _LABEL2INDEX[_lid] = _i


class CityscapesEval:
    """Accumulates the official confusion matrix from labelId maps."""

    def __init__(self):
        k = len(CITYSCAPES_EVAL_LABELS)
        self.confusion = np.zeros((k, k), np.int64)

    def update(self, pred_label_ids: np.ndarray,
               gt_label_ids: np.ndarray) -> None:
        """pred/gt: [H, W] uint8 official labelIds (gtFine_labelIds)."""
        p = _LABEL2INDEX[pred_label_ids.reshape(-1)]
        g = _LABEL2INDEX[gt_label_ids.reshape(-1)]
        # official protocol: pixels whose GT class is ignoreInEval are
        # skipped entirely; predictions of ignored classes on valid GT
        # count as errors against every class (no TP possible) — model
        # outputs here always map to one of the 19, matching the writer.
        valid = g >= 0
        p, g = p[valid], g[valid]
        pv = p >= 0
        k = self.confusion.shape[0]
        idx = g[pv] * k + p[pv]
        self.confusion += np.bincount(idx, minlength=k * k).reshape(k, k)
        # invalid predictions on valid GT: count as FN for the GT class
        if (~pv).any():
            miss = np.bincount(g[~pv], minlength=k)
            self._missed = getattr(self, "_missed", np.zeros(k, np.int64))
            self._missed += miss

    def compute(self) -> dict:
        cm = self.confusion.astype(np.float64)
        tp = np.diag(cm)
        fn = cm.sum(1) - tp + getattr(self, "_missed", 0)
        fp = cm.sum(0) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / (tp + fp + fn)
        present = (tp + fn) > 0
        iou = np.where(present, iou, np.nan)
        return {
            "classes": {name: float(iou[i] * 100)
                        for i, (_, name) in
                        enumerate(CITYSCAPES_EVAL_LABELS)},
            "mIoU": float(np.nanmean(iou) * 100),
            "aAcc": float(tp.sum() / max((tp + fn).sum(), 1) * 100),
        }


def evaluate_cityscapes_dir(pred_dir: str, gt_dir: str) -> dict:
    """Evaluate a directory of prediction labelId PNGs (the
    ``write_cityscapes_pred`` output) against ``*_gtFine_labelIds.png``
    files with matching stems under ``gt_dir`` — the offline protocol of
    cityscapesscripts' evalPixelLevelSemanticLabeling."""
    from PIL import Image

    ev = CityscapesEval()
    n = 0
    for root, _, files in sorted(os.walk(pred_dir)):
        for f in sorted(files):
            if not f.endswith(".png"):
                continue
            stem = f[:-4].replace("_leftImg8bit", "")
            rel = os.path.relpath(root, pred_dir)
            gt = os.path.join(gt_dir, rel, stem + "_gtFine_labelIds.png")
            if not os.path.exists(gt):
                continue
            pred = np.asarray(Image.open(os.path.join(root, f)))
            gtm = np.asarray(Image.open(gt))
            ev.update(pred, gtm)
            n += 1
    out = ev.compute()
    out["images"] = n
    return out
