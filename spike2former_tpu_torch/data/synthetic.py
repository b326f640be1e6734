"""Seeded synthetic data for runs without a dataset: train batches of uint8
RGB noise images and piecewise-constant semantic maps, so that matching and
the losses see realistic slot counts, and trees of such images in the
ADE20K, Cityscapes and COCO-Stuff 164k layouts (the latter two with the raw
label ids that ``tools/dataset_converters.py`` turns into train ids)."""
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


# Cityscapes (H, W) at the dataset's resolution
CITYSCAPES_SHAPE = (1024, 2048)


def _write_tree(root, shapes, seed, num_classes, classes, img_path,
                ann_path, encode):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i, hw in enumerate(shapes):
        images, sem = synthetic_batch(rng, 1, tuple(hw), num_classes,
                                      classes)
        for path, arr in ((img_path(i), images[0]),
                          (ann_path(i), encode(sem[0]).astype(np.uint8))):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(arr).save(path)
    return root


def write_cityscapes_tree(root: str, shapes=(CITYSCAPES_SHAPE,) * 2,
                          seed: int = 0, split: str = "val",
                          classes: tuple[int, int] = (5, 15)) -> str:
    """A seeded Cityscapes-layout tree under ``root``: for each (H, W) of
    ``shapes``, ``leftImg8bit/{split}/synth/synth_{i}_leftImg8bit.png`` and
    its ``gtFine/.../synth_{i}_gtFine_labelIds.png`` (official labelIds,
    ignore as the void id 0), for the ``cityscapes`` converter."""
    from ..evaluation.visualize import CITYSCAPES_TRAIN2LABEL

    def name(i):
        return f"{split}/synth/synth_{i:04d}"

    return _write_tree(
        root, shapes, seed, 19, classes,
        lambda i: os.path.join(root, "leftImg8bit",
                               name(i) + "_leftImg8bit.png"),
        lambda i: os.path.join(root, "gtFine",
                               name(i) + "_gtFine_labelIds.png"),
        lambda sem: np.where(sem == 255, 0,
                             CITYSCAPES_TRAIN2LABEL[np.clip(sem, 0, 18)]))


def write_coco_stuff_tree(root: str, shapes=((480, 640), (640, 480)),
                          seed: int = 0, split: str = "val",
                          classes: tuple[int, int] = (5, 20)) -> str:
    """A seeded COCO-Stuff 164k-layout tree under ``root``:
    ``images/{split}2017/{i}.jpg`` and ``annotations/{split}2017/{i}.png``
    in the dataset's 182-id encoding (255 unlabeled), for the
    ``coco_stuff`` converter."""
    unused = {11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90}
    ids = np.asarray([c for c in range(182) if c not in unused] + [255],
                     np.uint8)   # train id -> 182 id; 171 (ignore) -> 255
    return _write_tree(
        root, shapes, seed, 171, classes,
        lambda i: os.path.join(root, "images", f"{split}2017", f"{i:04d}.jpg"),
        lambda i: os.path.join(root, "annotations", f"{split}2017",
                               f"{i:04d}.png"),
        lambda sem: ids[np.where(sem == 255, 171, sem)])
