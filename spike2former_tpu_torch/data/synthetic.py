"""Seeded synthetic data for runs without a dataset: train batches of uint8
RGB noise images and piecewise-constant semantic maps, so that matching and
the losses see realistic slot counts, and trees of such images in the
ADE20K, Cityscapes and COCO-Stuff 164k layouts (the latter two with the raw
label ids that ``tools/dataset_converters.py`` turns into train ids) and
in the COCO panoptic layout."""
from __future__ import annotations

import json
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


# DDD17's event-frame resolution (H, W)
DDD17_SHAPE = (200, 352)


def write_ddd17_tree(root: str, n: int = 3, seed: int = 0,
                     split: str = "validation", hw=DDD17_SHAPE,
                     events: int = 400_000, t_bins: int = 4) -> str:
    """A seeded DDD17-layout tree under ``root``: ``n`` recordings of raw
    events ``[E, 4]`` (t, x, y, polarity) under ``root/raw/{split}``, each
    voxelized by the port's ``events`` converter
    (``tools/dataset_converters.py:convert_events_dir``, ``t_bins`` bins)
    into a 2-channel uint8 frame ``root/images/{split}/rec_{i}.npy``, and a
    6-class map ``root/annotations/{split}/rec_{i}.png`` (255 ignore).
    Events fall on a pixel with a probability that grows with its class,
    so the frames carry the map's structure."""
    from PIL import Image

    from ..tools.dataset_converters import convert_events_dir

    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "raw", split)
    ann_dir = os.path.join(root, "annotations", split)
    os.makedirs(raw, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    h, w = hw
    for i in range(n):
        _, sem = synthetic_batch(rng, 1, (h, w), 6, (2, 6))
        weight = np.where(sem[0] == 255, 1.0, sem[0] + 1.0).ravel()
        pix = rng.choice(h * w, events, p=weight / weight.sum())
        ev = np.stack([np.sort(rng.random(events)), pix % w, pix // w,
                       rng.integers(0, 2, events)], axis=1)
        np.save(os.path.join(raw, f"rec_{i}.npy"), ev)
        Image.fromarray(sem[0].astype(np.uint8)).save(
            os.path.join(ann_dir, f"rec_{i}.png"))
    convert_events_dir(raw, os.path.join(root, "images", split), (h, w),
                       t_bins)
    return root


# COCO-like image shapes (H, W)
COCO_LIKE_SHAPES = ((480, 640), (640, 480), (427, 640))


def write_coco_panoptic_tree(root: str, shapes=COCO_LIKE_SHAPES,
                             seed: int = 0, split: str = "val",
                             num_things: int = 80, num_stuff: int = 53,
                             instances: tuple[int, int] = (3, 8)) -> str:
    """A seeded COCO-panoptic-layout split under ``root``
    (``{split}2017/*.jpg``, ``annotations/panoptic_{split}2017/*.png`` and
    ``annotations/panoptic_{split}2017.json``) with one image of each
    (H, W) of ``shapes``.  Category ids are COCO-like, with gaps: things
    ``1 + i + i // 10``, stuff ``200 + 2 * j``.  Each image holds 2-4
    stuff segments (nearest-seed regions), ``instances`` thing boxes
    (classes drawn with repeats, so a class may have several instances),
    one of them a crowd, and a box of VOID (id 0); segment ids are drawn
    from the whole 24-bit range."""
    from PIL import Image

    from .panoptic import VOID, encode_pan_png

    rng = np.random.default_rng(seed)
    thing_ids = [1 + i + i // 10 for i in range(num_things)]
    stuff_ids = [200 + 2 * j for j in range(num_stuff)]
    cats = ([{"id": c, "name": f"thing_{c}", "isthing": 1}
             for c in thing_ids]
            + [{"id": c, "name": f"stuff_{c}", "isthing": 0}
               for c in stuff_ids])
    img_dir = os.path.join(root, f"{split}2017")
    pan_dir = os.path.join(root, "annotations", f"panoptic_{split}2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pan_dir, exist_ok=True)
    images, annotations = [], []
    for i, (h, w) in enumerate(shapes):
        k = int(rng.integers(2, min(4, num_stuff) + 1))
        n = int(rng.integers(instances[0], instances[1] + 1))
        seg_ids = rng.choice(np.arange(1, 2 ** 24), k + n, replace=False)
        stuff = rng.choice(stuff_ids, k, replace=False)
        yy, xx = np.mgrid[0:h, 0:w]
        seeds = rng.uniform(0, 1, (k, 2)) * (h, w)
        owner = ((yy[..., None] - seeds[:, 0]) ** 2
                 + (xx[..., None] - seeds[:, 1]) ** 2).argmin(-1)
        pan = seg_ids[owner].astype(np.int64)
        segs = [(int(seg_ids[j]), int(stuff[j]), 0) for j in range(k)]
        for j in range(n):
            bh, bw = (int(rng.integers(h // 10, h // 3)),
                      int(rng.integers(w // 10, w // 3)))
            y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            pan[y0:y0 + bh, x0:x0 + bw] = seg_ids[k + j]
            segs.append((int(seg_ids[k + j]),
                         int(rng.choice(thing_ids[:max(1, num_things // 4)])),
                         int(j == n - 1)))
        vh, vw = h // 8, w // 8
        y0, x0 = int(rng.integers(0, h - vh)), int(rng.integers(0, w - vw))
        pan[y0:y0 + vh, x0:x0 + vw] = VOID
        name = f"{split}_{i:04d}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(img_dir, f"{name}.jpg"))
        Image.fromarray(encode_pan_png(pan)).save(
            os.path.join(pan_dir, f"{name}.png"))
        images.append({"id": i, "file_name": f"{name}.jpg", "width": w,
                       "height": h})
        annotations.append({
            "image_id": i, "file_name": f"{name}.png",
            "segments_info": [
                {"id": sid, "category_id": cat, "iscrowd": crowd,
                 "area": int((pan == sid).sum())}
                for sid, cat, crowd in segs if (pan == sid).any()]})
    with open(os.path.join(root, "annotations",
                           f"panoptic_{split}2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)
    return root


def confident_merge_inputs(seed: int = 0, b: int = 2, nq: int = 10,
                           k: int = 5, hw: tuple[int, int] = (24, 32)):
    """Inputs of the panoptic merge that a trained model would give and
    random weights do not: (class scores [b, nq, k+1], mask logits
    [b, nq, H, W]) float32, most queries confident in one class and each
    mask a noisy blob, so that the merge keeps some queries, drops
    others, and yields thing instances, stuff and void."""
    rng = np.random.default_rng(seed)
    cls = rng.normal(0, 1, (b, nq, k + 1))
    top = rng.integers(0, k, (b, nq))
    np.put_along_axis(cls, top[..., None], rng.uniform(2, 8, (b, nq, 1)), -1)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    centres = rng.uniform(0, 1, (b, nq, 2)) * hw
    dist = np.hypot(yy - centres[..., 0, None, None],
                    xx - centres[..., 1, None, None])
    masks = 6.0 - dist / (min(hw) / 16) + rng.normal(0, 0.5, dist.shape)
    return cls.astype(np.float32), masks.astype(np.float32)
