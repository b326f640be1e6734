"""Prediction overlays and the Cityscapes submission writer (port of
``spike2former_tpu/evaluation/visualize.py``; mmseg's SegLocalVisualizer,
local_visualizer.py:16-230, and the labelId writer of CityscapesMetric,
metrics/citys_metric.py:26-160)."""
from __future__ import annotations

import os

import numpy as np


def default_palette(num_classes: int, seed: int = 42) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(0, 255, (num_classes, 3)).astype(np.uint8)


def draw_sem_seg(image: np.ndarray, sem_seg: np.ndarray,
                 palette: np.ndarray | None = None,
                 alpha: float = 0.5,
                 ignore_index: int = 255) -> np.ndarray:
    """A class map [H, W] int laid over an RGB image [H, W, 3] uint8 at
    ``alpha``; ``ignore_index`` pixels keep the image."""
    valid = sem_seg != ignore_index
    if palette is None:
        num_classes = int(sem_seg[valid].max()) + 1 if valid.any() else 1
        palette = default_palette(num_classes)
    color = np.zeros_like(image)
    color[valid] = palette[np.clip(sem_seg[valid], 0, len(palette) - 1)]
    out = image.astype(np.float32) * (1 - alpha) + color.astype(
        np.float32) * alpha
    out[~valid] = image[~valid]
    return out.astype(np.uint8)


# trainId -> labelId for the 19 Cityscapes eval classes
CITYSCAPES_TRAIN2LABEL = np.asarray(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32,
     33], np.uint8)


def write_cityscapes_pred(pred_train_ids: np.ndarray, out_path: str) -> str:
    """Write a trainId map [H, W] as the official labelId PNG (what
    CityscapesMetric does before cityscapesscripts): trainIds outside
    0-18 become labelId 0.  Returns ``out_path``."""
    from PIL import Image

    label_ids = np.full(pred_train_ids.shape, 0, np.uint8)
    valid = (pred_train_ids >= 0) & (pred_train_ids < 19)
    label_ids[valid] = CITYSCAPES_TRAIN2LABEL[pred_train_ids[valid]]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(label_ids).save(out_path)
    return out_path
