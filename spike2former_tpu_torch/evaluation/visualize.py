"""Prediction overlays (port of ``default_palette`` and ``draw_sem_seg`` of
``spike2former_tpu/evaluation/visualize.py``; mmseg's SegLocalVisualizer,
local_visualizer.py:16-230)."""
from __future__ import annotations

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
