"""Host-side train and eval transforms (port of
``spike2former_tpu/data/transforms.py``: the loaders, the ADE20K train
pipeline with ``mosaic``, and the test pipeline).

The active ADE20K train pipeline
(configs/Spike2Former/SDTv2_maskformer_DCNpixelDecoder_ade20k.py:168-180):
RandomChoiceResize (ResizeShortestEdge, scales 320..1280, max 2560) →
RandomCrop(512, cat_max_ratio=0.75) → RandomFlip(0.5) →
PhotoMetricDistortion → pad to the crop.  Every random draw comes from the
caller's ``np.random.Generator`` in the JAX package's order, so the same
generator state gives bit-identical samples.

Pure numpy/PIL functions over a ``sample`` dict:
{image: uint8 [H,W,3] RGB, sem_seg: int [H,W] or None, meta: {...}}.
"""
from __future__ import annotations

import numpy as np
from PIL import Image

Sample = dict


def load_image(path: str) -> np.ndarray:
    """An RGB image [H, W, 3] uint8; a ``.npy`` / ``.npz`` file is an event
    frame (``_load_event_frame``)."""
    if path.endswith((".npy", ".npz")):
        return _load_event_frame(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _load_event_frame(path: str) -> np.ndarray:
    """An event-camera frame stored as .npy / .npz (the first array of an
    .npz), as the DDD17 pipeline's LoadImageFromNpyFile loads it (mmseg
    transforms/loading.py:630-693), canonicalized to [H, W, 3] uint8 for the
    3-channel image pipeline: a 2-channel frame (positive and negative
    event counts) gets a zero third channel, a 1-channel one is repeated,
    more channels are cut to 3; other dtypes are clipped to [0, 255] and
    cast (floats truncate)."""
    arr = np.load(path)
    if isinstance(arr, np.lib.npyio.NpzFile):
        arr = arr[arr.files[0]]
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    elif arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    elif arr.shape[-1] == 2:
        arr = np.concatenate([arr, np.zeros_like(arr[..., :1])], axis=-1)
    else:
        arr = arr[..., :3]
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255)
    return arr.astype(np.uint8)


def load_annotation(path: str, reduce_zero_label: bool) -> np.ndarray:
    """A label map [H, W] int32; ``reduce_zero_label`` maps 0 (unlabeled)
    to 255 and k to k - 1 (mmseg LoadAnnotations)."""
    with Image.open(path) as im:
        seg = np.asarray(im)
    if seg.ndim == 3:
        seg = seg[..., 0]
    seg = seg.astype(np.int32)
    if reduce_zero_label:
        seg = np.where(seg == 0, 255, seg - 1)
        seg = np.where(seg == 254, 255, seg)
    return seg


def _pil_resize(arr: np.ndarray, size_wh: tuple[int, int],
                nearest: bool) -> np.ndarray:
    if arr.ndim == 2:
        return np.asarray(Image.fromarray(arr.astype(np.int32), "I").resize(
            size_wh, Image.NEAREST), np.int32)
    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(arr).resize(size_wh, mode))


def _apply_resize(sample: Sample, nh: int, nw: int) -> Sample:
    out = dict(sample)
    out["image"] = _pil_resize(sample["image"], (nw, nh), nearest=False)
    if sample.get("sem_seg") is not None:
        out["sem_seg"] = _pil_resize(sample["sem_seg"], (nw, nh),
                                     nearest=True)
    out["meta"] = dict(out.get("meta", {}), img_shape=(nh, nw))
    return out


def resize_shortest_edge(sample: Sample, scale: int, max_size: int) -> Sample:
    """ResizeShortestEdge (transforms.py:1324): the shortest side to
    ``scale``, capped so that the longest side is at most ``max_size``,
    keeping the aspect ratio."""
    h, w = sample["image"].shape[:2]
    s = scale / min(h, w)
    if max(h, w) * s > max_size:
        s = max_size / max(h, w)
    return _apply_resize(sample, int(round(h * s)), int(round(w * s)))


def resize_keep_ratio(sample: Sample, scale_long: int, scale_short: int
                      ) -> Sample:
    """mmcv keep-ratio Resize with scale=(long, short): the eval resize."""
    h, w = sample["image"].shape[:2]
    s = min(scale_long / max(h, w), scale_short / min(h, w))
    return _apply_resize(sample, int(h * s + 0.5), int(w * s + 0.5))


def random_choice_resize(sample: Sample, rng: np.random.Generator,
                         scales=tuple(int(x * 0.1 * 640) for x in
                                      range(5, 21)),
                         max_size: int = 2560) -> Sample:
    """RandomChoiceResize: ``resize_shortest_edge`` to a scale drawn from
    ``scales`` (320..1280)."""
    scale = int(rng.choice(np.asarray(scales)))
    return resize_shortest_edge(sample, scale, max_size)


def random_crop(sample: Sample, rng: np.random.Generator,
                crop_size: tuple[int, int], cat_max_ratio: float = 0.75,
                ignore_index: int = 255) -> Sample:
    """RandomCrop with category-dominance rejection (transforms.py:206):
    re-draw up to 10 crops until no class holds ``cat_max_ratio`` or more
    of the labelled pixels (and at least two classes are present)."""
    img = sample["image"]
    seg = sample.get("sem_seg")
    ch, cw = crop_size
    h, w = img.shape[:2]

    def draw():
        y = int(rng.integers(0, max(h - ch, 0) + 1))
        x = int(rng.integers(0, max(w - cw, 0) + 1))
        return y, x

    y, x = draw()
    if seg is not None and cat_max_ratio < 1.0:
        for _ in range(10):
            crop = seg[y:y + ch, x:x + cw]
            _, counts = np.unique(crop[crop != ignore_index],
                                  return_counts=True)
            if len(counts) > 1 and counts.max() / counts.sum() \
                    < cat_max_ratio:
                break
            y, x = draw()
    out = dict(sample)
    out["image"] = img[y:y + ch, x:x + cw]
    if seg is not None:
        out["sem_seg"] = seg[y:y + ch, x:x + cw]
    return out


def random_flip(sample: Sample, rng: np.random.Generator,
                prob: float = 0.5) -> Sample:
    """Horizontal flip of image and map with probability ``prob``."""
    if rng.uniform() < prob:
        out = dict(sample)
        out["image"] = sample["image"][:, ::-1]
        if sample.get("sem_seg") is not None:
            out["sem_seg"] = sample["sem_seg"][:, ::-1]
        return out
    return sample


def photometric_distortion(sample: Sample, rng: np.random.Generator,
                           brightness_delta: int = 32,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5),
                           hue_delta: int = 18) -> Sample:
    """PhotoMetricDistortion (transforms.py:581): random brightness,
    contrast (before or after the rest), saturation and hue, the last two
    through an HSV round trip in numpy."""
    img = sample["image"].astype(np.float32)

    def brightness(x):
        if rng.integers(2):
            x = x + float(rng.uniform(-brightness_delta, brightness_delta))
        return x

    def contrast(x):
        if rng.integers(2):
            x = x * float(rng.uniform(*contrast_range))
        return x

    def rgb_to_hsv(x):
        x = np.clip(x, 0, 255) / 255.0
        mx = x.max(-1)
        mn = x.min(-1)
        diff = mx - mn + 1e-12
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        h = np.where(
            mx == r, (g - b) / diff % 6,
            np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4)) * 60
        s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
        return h, s, mx

    def hsv_to_rgb(h, s, v):
        h = (h % 360) / 60.0
        c = v * s
        x = c * (1 - np.abs(h % 2 - 1))
        m = v - c
        z = np.zeros_like(c)
        idx = h.astype(np.int32) % 6
        sectors = [idx == 0, idx == 1, idx == 2, idx == 3, idx == 4]
        r = np.select(sectors, [c, x, z, z, x], default=c)
        g = np.select(sectors, [x, c, c, x, z], default=z)
        b = np.select(sectors, [z, z, x, c, c], default=x)
        return np.stack([r + m, g + m, b + m], -1) * 255.0

    img = brightness(img)
    mode = int(rng.integers(2))
    if mode == 1:
        img = contrast(img)
    if rng.integers(2) or rng.integers(2):
        h, s, v = rgb_to_hsv(img)
        if rng.integers(2):
            s = s * float(rng.uniform(*saturation_range))
        if rng.integers(2):
            h = h + float(rng.uniform(-hue_delta, hue_delta))
        img = hsv_to_rgb(h, np.clip(s, 0, 1), np.clip(v, 0, 1))
    if mode == 0:
        img = contrast(img)
    out = dict(sample)
    out["image"] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def mosaic(samples: list[Sample], rng: np.random.Generator,
           img_scale: tuple[int, int] = (512, 512),
           center_ratio_range: tuple[float, float] = (0.5, 1.5),
           pad_val: int = 0, seg_pad_val: int = 255) -> Sample:
    """RandomMosaic: 4 samples stitched into a (2H, 2W) canvas around a
    random center, each quadrant filled with the (cropped) corresponding
    image and the rest padded."""
    if len(samples) != 4:
        raise ValueError(f"mosaic needs 4 samples, got {len(samples)}")
    hs, ws = img_scale
    canvas = np.full((2 * hs, 2 * ws, 3), pad_val, np.uint8)
    seg_canvas = np.full((2 * hs, 2 * ws), seg_pad_val, np.int32)
    cy = int(rng.uniform(*center_ratio_range) * hs)
    cx = int(rng.uniform(*center_ratio_range) * ws)

    for i, s in enumerate(samples):
        img = s["image"]
        h, w = img.shape[:2]
        if i == 0:    # top-left: bottom-right corner at the center
            y1, x1 = max(cy - h, 0), max(cx - w, 0)
            y2, x2 = cy, cx
            crop = (slice(h - (y2 - y1), h), slice(w - (x2 - x1), w))
        elif i == 1:  # top-right
            y1, x1 = max(cy - h, 0), cx
            y2, x2 = cy, min(cx + w, 2 * ws)
            crop = (slice(h - (y2 - y1), h), slice(0, x2 - x1))
        elif i == 2:  # bottom-left
            y1, x1 = cy, max(cx - w, 0)
            y2, x2 = min(cy + h, 2 * hs), cx
            crop = (slice(0, y2 - y1), slice(w - (x2 - x1), w))
        else:         # bottom-right
            y1, x1 = cy, cx
            y2, x2 = min(cy + h, 2 * hs), min(cx + w, 2 * ws)
            crop = (slice(0, y2 - y1), slice(0, x2 - x1))
        canvas[y1:y2, x1:x2] = img[crop]
        if s.get("sem_seg") is not None:
            seg_canvas[y1:y2, x1:x2] = s["sem_seg"][crop]

    meta = dict(samples[0].get("meta", {}), img_shape=(2 * hs, 2 * ws))
    return {"image": canvas, "sem_seg": seg_canvas, "meta": meta}


def pad_to(sample: Sample, size: tuple[int, int], pad_val: int = 0,
           seg_pad_val: int = 255) -> Sample:
    """Bottom-right pad image & seg to a static size (mmseg stack_batch)."""
    img = sample["image"]
    h, w = img.shape[:2]
    ph, pw = max(size[0] - h, 0), max(size[1] - w, 0)
    out = dict(sample)
    out["image"] = np.pad(img, ((0, ph), (0, pw), (0, 0)),
                          constant_values=pad_val)
    if sample.get("sem_seg") is not None:
        out["sem_seg"] = np.pad(sample["sem_seg"], ((0, ph), (0, pw)),
                                constant_values=seg_pad_val)
    out["meta"] = dict(out.get("meta", {}), pad_shape=(h, w))
    return out


def train_pipeline(sample: Sample, rng: np.random.Generator,
                   crop_size=(512, 512)) -> Sample:
    """The active Spike2Former ADE20K train pipeline."""
    sample = random_choice_resize(sample, rng)
    sample = random_crop(sample, rng, crop_size)
    sample = random_flip(sample, rng)
    sample = photometric_distortion(sample, rng)
    return pad_to(sample, crop_size)


def train_pipeline_mix(sample: Sample, extra_sample_fn,
                       rng: np.random.Generator, crop_size=(512, 512),
                       mosaic_prob: float = 0.5) -> Sample:
    """The MultiImageMixDataset wrapper as a function: with probability
    ``mosaic_prob`` the sample is stitched by ``mosaic`` with 3 more raw
    samples from ``extra_sample_fn()``, on a canvas of twice the crop;
    then ``train_pipeline`` runs on the result."""
    if rng.uniform() < mosaic_prob:
        group = [sample] + [extra_sample_fn() for _ in range(3)]
        sample = mosaic(group, rng, img_scale=crop_size)
    return train_pipeline(sample, rng, crop_size)


def test_pipeline(sample: Sample, scale=(2048, 512),
                  size_divisor: int | None = 32,
                  bucket: int = 0) -> Sample:
    """The eval pipeline: keep-ratio resize to ``scale``, then bottom-right
    padding to a multiple of ``bucket`` when set, else to a multiple of
    ``size_divisor``."""
    sample = resize_keep_ratio(sample, *scale)
    h, w = sample["image"].shape[:2]
    multiple = bucket or size_divisor
    if multiple:
        sample = pad_to(sample, (-(-h // multiple) * multiple,
                                 -(-w // multiple) * multiple))
    return sample
