"""COCO-panoptic data (port of ``spike2former_tpu/data/panoptic.py``): the
JSON and id-PNG dataset, the GT conversion and the train batches.

Reference: the COCO panoptic format (panopticapi): a PNG per image whose
RGB encodes a segment id (``id = R + 256*G + 256^2*B``) and a JSON with
each image's ``segments_info`` (id, category_id, iscrowd) and the
categories (``isthing``); mmdet's ``preprocess_panoptic_gt`` makes one
(label, mask) pair per thing instance and per stuff segment, with
contiguous ids numbering the things first (0..num_things-1), then stuff.

The GT is padded on the host to ``max_gt`` segments per image (labels
[G], masks [G, h, w], valid [G]); crowd segments are left out of
matching, as the reference's sampler ignores them.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from .transforms import (Sample, load_image, pad_to, photometric_distortion,
                         random_crop, random_flip, resize_shortest_edge)

VOID = 0  # panoptic PNG id of unlabeled pixels


def decode_pan_png(rgb: np.ndarray) -> np.ndarray:
    """RGB panoptic PNG -> int32 segment-id map (panopticapi rgb2id)."""
    rgb = rgb.astype(np.int32)
    return rgb[..., 0] + 256 * rgb[..., 1] + 256 * 256 * rgb[..., 2]


def encode_pan_png(ids: np.ndarray) -> np.ndarray:
    """Segment-id map -> RGB uint8 PNG array (panopticapi id2rgb)."""
    ids = ids.astype(np.int64)
    return np.stack([ids % 256, (ids // 256) % 256,
                     (ids // 65536) % 256], -1).astype(np.uint8)


@dataclass
class PanopticDataset:
    """A split in the COCO-panoptic layout::

      {root}/{split}2017/                      *.jpg
      {root}/annotations/panoptic_{split}2017.json
      {root}/annotations/panoptic_{split}2017/ *.png

    ``num_things`` is read from the categories (the argument is
    overwritten, as in the JAX package)."""

    data_root: str
    split: str = "train"
    num_things: int = field(default=80)

    def __post_init__(self):
        ann = os.path.join(self.data_root, "annotations",
                           f"panoptic_{self.split}2017.json")
        with open(ann) as f:
            meta = json.load(f)
        self.pan_dir = os.path.join(self.data_root, "annotations",
                                    f"panoptic_{self.split}2017")
        self.img_dir = os.path.join(self.data_root, f"{self.split}2017")
        # contiguous ids: things first, then stuff (mmdet's convention)
        things = [c for c in meta["categories"] if c["isthing"]]
        stuff = [c for c in meta["categories"] if not c["isthing"]]
        self.num_things, self.num_stuff = len(things), len(stuff)
        self.cat2contig = {c["id"]: i for i, c in enumerate(things)}
        self.cat2contig.update(
            {c["id"]: self.num_things + i for i, c in enumerate(stuff)})
        self.classes = tuple(c["name"] for c in things + stuff)
        images = {im["id"]: im for im in meta["images"]}
        self.anns = []
        for a in meta["annotations"]:
            im = images[a["image_id"]]
            self.anns.append({
                "img": os.path.join(self.img_dir, im.get(
                    "file_name", a["file_name"].replace(".png", ".jpg"))),
                "pan": os.path.join(self.pan_dir, a["file_name"]),
                "segments": a["segments_info"]})

    @property
    def num_classes(self) -> int:
        return self.num_things + self.num_stuff

    def __len__(self) -> int:
        return len(self.anns)

    def load(self, idx: int) -> Sample:
        """{image: uint8 [H, W, 3], pan_ids: int32 [H, W], segments:
        [(segment id, contiguous label, iscrowd)], sem_seg: None, meta}."""
        a = self.anns[idx]
        image = load_image(a["img"])
        pan = decode_pan_png(load_image(a["pan"]))
        segments = [(s["id"], self.cat2contig[s["category_id"]],
                     int(s.get("iscrowd", 0))) for s in a["segments"]]
        return {"image": image, "pan_ids": pan, "segments": segments,
                "sem_seg": None,
                "meta": {"img_path": a["img"], "ori_shape": image.shape[:2]}}


def panoptic_to_instances(pan_ids: np.ndarray, segments, max_gt: int,
                          num_things: int):
    """One (label, binary mask) pair per non-crowd segment present in
    ``pan_ids``, in the order of ``segments``, padded to ``max_gt`` (the
    valid ones first).  Returns (labels [G] int32, masks [G, h, w] float32,
    valid [G] bool)."""
    h, w = pan_ids.shape
    labels = np.zeros((max_gt,), np.int32)
    masks = np.zeros((max_gt, h, w), np.float32)
    valid = np.zeros((max_gt,), bool)
    n = 0
    for seg_id, label, iscrowd in segments:
        if iscrowd or n >= max_gt:
            continue  # crowd regions are not matched (reference sampler)
        m = pan_ids == seg_id
        if not m.any():
            continue
        labels[n] = label
        masks[n] = m
        valid[n] = True
        n += 1
    return labels, masks, valid


def panoptic_maps(pan_ids: np.ndarray, segments):
    """Per-pixel (label, instance, crowd) maps for PQ: label the
    contiguous class id (-1 void), instance the segment's running index
    (from 1), crowd where the segment is a crowd."""
    label = np.full(pan_ids.shape, -1, np.int32)
    inst = np.zeros(pan_ids.shape, np.int32)
    crowd = np.zeros(pan_ids.shape, bool)
    for n, (seg_id, lab, iscrowd) in enumerate(segments):
        m = pan_ids == seg_id
        label[m] = lab
        inst[m] = n + 1
        if iscrowd:
            crowd[m] = True
    return label, inst, crowd


def panoptic_train_batches(dataset: PanopticDataset, batch_size: int,
                           crop_size=(512, 512), max_gt: int = 64,
                           seed: int = 0):
    """Endless panoptic train batches: (images [B, H, W, 3] float32, labels
    [B, G] int32, masks [B, G, H, W] float32, valid [B, G] bool).

    The semantic train transforms (resize of the shortest edge to a scale
    drawn from 320..1280, crop, flip, photometric distortion, pad) run
    with the int32 id map as ``sem_seg`` (nearest resizes in PIL's mode
    ``I`` keep the ids exact; VOID pads), drawing from one
    ``np.random.default_rng(seed)`` in the JAX package's order, so the
    batches are bit-identical to its; the GT segments are built from the
    cropped map, and a crop with none is drawn again."""
    rng = np.random.default_rng(seed)
    while True:
        batch = {"image": [], "labels": [], "masks": [], "valid": []}
        while len(batch["image"]) < batch_size:
            s = dataset.load(int(rng.integers(0, len(dataset))))
            work = {"image": s["image"], "sem_seg": s["pan_ids"], "meta": {}}
            scale = int(rng.choice([int(x * 0.1 * 640)
                                    for x in range(5, 21)]))
            work = resize_shortest_edge(work, scale, 2560)
            work = random_crop(work, rng, crop_size, cat_max_ratio=1.0)
            work = random_flip(work, rng)
            work = photometric_distortion(work, rng)
            work = pad_to(work, crop_size, seg_pad_val=VOID)
            labels, masks, valid = panoptic_to_instances(
                work["sem_seg"], s["segments"], max_gt, dataset.num_things)
            if not valid.any():
                continue
            batch["image"].append(work["image"].astype(np.float32))
            batch["labels"].append(labels)
            batch["masks"].append(masks)
            batch["valid"].append(valid)
        yield tuple(np.stack(batch[k])
                    for k in ("image", "labels", "masks", "valid"))
