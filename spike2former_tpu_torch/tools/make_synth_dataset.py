"""Generate the structured synthetic segmentation set of the learning run
(port of the repository's ``tools/make_synth_dataset.py``, which it
reproduces byte for byte: the same images and label maps for a seed).

ADE20K on-disk layout (images/{training,validation} +
annotations/{training,validation}), so the real data layer (file
discovery, jpeg/png IO, train transforms, bucketed eval) is exercised
unchanged.  The task is non-trivial but learnable without a pretrained
backbone:

* K classes (default 30), each with a fixed base color + one of four
  procedural textures (flat / stripes / checker / speckle).
* Each scene: a 2-class background split + 6-14 foreground blobs
  (rectangles, ellipses, triangles) at scales 0.05-0.4 of the image,
  z-ordered, so images contain 5-15 distinct classes with occlusion
  boundaries.
* Color jitter, global illumination gradient, and pixel noise keep
  single-pixel color lookup insufficient: texture + shape context is
  required to separate confusable class pairs (pairs share base colors
  and differ only in texture).
* Labels are written WITHOUT the color key (PNG id maps, ADE convention:
  0 = ignore, ids 1..K; the loader's reduce_zero_label shifts to 0..K-1).

Determinism: each image is generated from fold-in(seed, index), so any
subset regenerates bit-identically, in any order.

Usage:
  python -m spike2former_tpu_torch.tools.make_synth_dataset \\
      --root /tmp/synthseg --train 2000 --val 200 --size 512 --classes 30
"""
from __future__ import annotations

import argparse
import os

import numpy as np

# (split, index offset of its images in the seed's sequence)
SPLITS = (("training", 0), ("validation", 10 ** 6))


def _texture(rng, kind, h, w, base, jitter):
    """Class-keyed texture patch in [0,255]^3."""
    yy, xx = np.mgrid[0:h, 0:w]
    c = np.asarray(base, np.float32) + rng.normal(0, jitter, 3)
    img = np.broadcast_to(c, (h, w, 3)).copy()
    if kind == 1:  # stripes
        period = 8 + int(rng.integers(0, 12))
        phase = ((yy + 2 * xx) // period) % 2
        img *= (0.65 + 0.7 * phase)[..., None]
    elif kind == 2:  # checker
        period = 12 + int(rng.integers(0, 12))
        phase = ((yy // period) + (xx // period)) % 2
        img *= (0.65 + 0.7 * phase)[..., None]
    elif kind == 3:  # speckle
        img *= (0.6 + 0.8 * (rng.random((h, w)) > 0.5))[..., None]
    return img


def _blob_mask(rng, h, w):
    """One random shape mask at a random scale/position."""
    kind = int(rng.integers(0, 3))
    s = float(rng.uniform(0.05, 0.4))
    bh, bw = max(8, int(h * s)), max(8, int(w * s * rng.uniform(0.5, 2.0)))
    bw = min(bw, w)
    y0 = int(rng.integers(0, h - bh + 1))
    x0 = int(rng.integers(0, w - bw + 1))
    m = np.zeros((h, w), bool)
    if kind == 0:  # rectangle
        m[y0:y0 + bh, x0:x0 + bw] = True
    elif kind == 1:  # ellipse
        yy, xx = np.mgrid[0:bh, 0:bw]
        e = (((yy - bh / 2) / (bh / 2)) ** 2
             + ((xx - bw / 2) / (bw / 2)) ** 2) <= 1.0
        m[y0:y0 + bh, x0:x0 + bw] = e
    else:  # triangle
        yy, xx = np.mgrid[0:bh, 0:bw]
        t = (xx / max(bw - 1, 1)) >= np.abs(2 * yy / max(bh - 1, 1) - 1)
        m[y0:y0 + bh, x0:x0 + bw] = t
    return m


def class_table(num_classes, seed=7):
    """Fixed per-class (color, texture) key; confusable pairs share colors."""
    rng = np.random.default_rng(seed)
    colors = rng.integers(30, 226, (num_classes, 3)).astype(np.float32)
    textures = np.arange(num_classes) % 4
    # every even/odd class pair shares a base color -> texture matters
    colors[1::2] = colors[0::2][: colors[1::2].shape[0]]
    return colors, textures


def render(seed, index, size, num_classes):
    """(image [size, size, 3] uint8, label map [size, size] uint8 with ids
    1..K) of image ``index`` of ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    colors, textures = class_table(num_classes)
    h = w = size
    sem = np.zeros((h, w), np.int32)

    # background: 2-class split at a random angle
    c0, c1 = rng.choice(num_classes, 2, replace=False)
    yy, xx = np.mgrid[0:h, 0:w]
    ang = rng.uniform(0, np.pi)
    split = (np.cos(ang) * (xx - w / 2) + np.sin(ang) * (yy - h / 2)) > \
        rng.uniform(-h / 4, h / 4)
    sem[:] = c0
    sem[split] = c1

    for _ in range(int(rng.integers(6, 15))):
        cls = int(rng.integers(0, num_classes))
        sem[_blob_mask(rng, h, w)] = cls

    img = np.zeros((h, w, 3), np.float32)
    for cls in np.unique(sem):
        m = sem == cls
        patch = _texture(rng, int(textures[cls]), h, w,
                         colors[cls], jitter=10.0)
        img[m] = patch[m]

    # illumination gradient + noise
    g = rng.uniform(-0.25, 0.25)
    img *= (1.0 + g * (xx - w / 2) / w)[..., None]
    img += rng.normal(0, 6.0, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    # ADE convention: stored ids 1..K, 0 reserved (reduce_zero_label)
    return img, (sem + 1).astype(np.uint8)


def write_split(root, split, n, size=512, num_classes=30, seed=0):
    """Write ``n`` images of ``split`` ('training' or 'validation') under
    ``root``; returns the image directory."""
    from PIL import Image

    offset = dict(SPLITS)[split]
    img_dir = os.path.join(root, "images", split)
    ann_dir = os.path.join(root, "annotations", split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for i in range(n):
        img, ann = render(seed, offset + i, size, num_classes)
        Image.fromarray(img).save(
            os.path.join(img_dir, f"synth_{i:06d}.jpg"), quality=92)
        Image.fromarray(ann).save(
            os.path.join(ann_dir, f"synth_{i:06d}.png"))
    return img_dir


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--train", type=int, default=2000)
    ap.add_argument("--val", type=int, default=200)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--classes", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    for split, n in (("training", args.train), ("validation", args.val)):
        img_dir = write_split(args.root, split, n, args.size, args.classes,
                              args.seed)
        print(f"{split}: {n} images -> {img_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
