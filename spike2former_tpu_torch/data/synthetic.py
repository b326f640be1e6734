"""Seeded synthetic data for runs without a dataset: train batches of uint8
RGB noise images and piecewise-constant semantic maps, so that matching and
the losses see realistic slot counts, and an ADE20K-layout tree of such
images for the eval path."""
from __future__ import annotations

import os

import numpy as np


# ADE20K-like image shapes (H, W), three of each: a tree of them gives
# the preset's batch of 6 two batches an epoch
ADE_LIKE_SHAPES = ((512, 683), (683, 512), (512, 512), (384, 512)) * 3


def synthetic_batch(rng: np.random.Generator, b: int = 6,
                    hw: tuple[int, int] = (512, 512), num_classes: int = 150,
                    classes: tuple[int, int] = (10, 30)):
    """(images [b, H, W, 3] uint8, sem_seg [b, H, W] int64): each map holds
    between ``classes[0]`` and ``classes[1]`` distinct classes (at most
    ``num_classes``) in nearest-seed regions on an 8-pixel grid (cut at
    the map's edge), a strip
    on the left and a box of ignore (255) pixels."""
    images = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    gh, gw = -(-hw[0] // 8), -(-hw[1] // 8)
    yy, xx = np.mgrid[0:gh, 0:gw]
    sem = np.empty((b, *hw), np.int64)
    box = hw[0] // 10
    for i in range(b):
        k = min(int(rng.integers(classes[0], classes[1] + 1)), num_classes)
        ids = rng.choice(num_classes, k, replace=False)
        seeds = rng.uniform(0, 1, (2 * k, 2)) * (gh, gw)
        owner = ((yy[..., None] - seeds[:, 0]) ** 2
                 + (xx[..., None] - seeds[:, 1]) ** 2).argmin(-1)
        sem[i] = np.kron(ids[owner % k], np.ones((8, 8), np.int64))[
            :hw[0], :hw[1]]
        sem[i, :, :int(rng.integers(1, 5)) * hw[1] // 100] = 255
        y0, x0 = rng.integers(0, hw[0] - box, 2)
        sem[i, y0:y0 + box, x0:x0 + box] = 255
    return images, sem


def write_ade_tree(root: str, shapes, seed: int = 0,
                   split: str = "validation", num_classes: int = 150,
                   classes: tuple[int, int] = (10, 30)) -> str:
    """A seeded ADE20K-layout tree under ``root`` for runs without the
    dataset: one ``.jpg`` image and ``.png`` annotation of each (H, W) of
    ``shapes`` in ``split`` (``validation`` or ``training``), the maps of
    ``synthetic_batch`` (``num_classes``, ``classes``) in the ADE20K
    encoding (class k stored as k + 1, 0 unlabeled)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images", split)
    ann_dir = os.path.join(root, "annotations", split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for i, hw in enumerate(shapes):
        images, sem = synthetic_batch(rng, 1, tuple(hw), num_classes,
                                      classes)
        ann = np.where(sem[0] == 255, 0, sem[0] + 1).astype(np.uint8)
        Image.fromarray(images[0]).save(os.path.join(img_dir, f"{i:04d}.jpg"))
        Image.fromarray(ann).save(os.path.join(ann_dir, f"{i:04d}.png"))
    return root
