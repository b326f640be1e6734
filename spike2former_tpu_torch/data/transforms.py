"""Host-side eval transforms (port of ``load_image``, ``load_annotation``,
``resize_keep_ratio``, ``pad_to`` and ``test_pipeline`` of
``spike2former_tpu/data/transforms.py``).

Pure numpy/PIL functions over a ``sample`` dict:
{image: uint8 [H,W,3] RGB, sem_seg: int [H,W] or None, meta: {...}}.
"""
from __future__ import annotations

import numpy as np
from PIL import Image

Sample = dict


def load_image(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


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


def resize_keep_ratio(sample: Sample, scale_long: int, scale_short: int
                      ) -> Sample:
    """mmcv keep-ratio Resize with scale=(long, short): the eval resize."""
    h, w = sample["image"].shape[:2]
    s = min(scale_long / max(h, w), scale_short / min(h, w))
    return _apply_resize(sample, int(h * s + 0.5), int(w * s + 0.5))


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
