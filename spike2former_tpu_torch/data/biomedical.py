"""Biomedical 3D augmentation set (host-side numpy; the port's copy of
``spike2former_tpu/data/biomedical.py``), completing the reference's
transform zoo.

Reference: mmseg/datasets/transforms/transforms.py —
``BioMedical3DRandomCrop`` (:1408), ``BioMedicalGaussianNoise`` (:1604),
``BioMedicalGaussianBlur`` (:1665), ``BioMedicalRandomGamma`` (:1782),
``BioMedical3DPad`` (:1901), ``BioMedical3DRandomFlip`` (:2033).  These
serve mmseg's nnUNet-style 3D medical pipelines (e.g. Synapse); no
Spike2Former config activates them, so they live in their own module and
follow this repo's conventions: pure functions over
``img: float32 [N, Z, Y, X]`` (N = modalities) and
``seg: int [Z, Y, X]`` with an explicit ``np.random.Generator`` —
no global RNG, no registry, no mutable transform objects.

Documented deviations from reference quirks (both inactive upstream):
* ``BioMedical3DPad._to_pad`` computes the X pad from ``img.shape[2]``
  (the Y axis) — an upstream typo; ``pad_3d`` here pads X from the X
  axis as the docstring intends.
* ``BioMedical3DPad._pad_seg`` returns ``pad_gt_seg[1:]`` (an empty
  array from the length-1 modality axis); ``pad_3d`` returns the padded
  ``[Z, Y, X]`` map, the evident intent.
"""
from __future__ import annotations

import numpy as np


def _as_triple(v) -> tuple[int, int, int]:
    if isinstance(v, (int, np.integer)):
        return (int(v), int(v), int(v))
    v = tuple(int(x) for x in v)
    assert len(v) == 3 and all(x > 0 for x in v)
    return v


def random_crop_3d(img: np.ndarray, seg: np.ndarray,
                   rng: np.random.Generator, crop_shape,
                   keep_foreground: bool = True
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Random 3D patch crop, optionally biased toward foreground.

    Matches the reference's procedure exactly (transforms.py:1448-1600):
    with ``keep_foreground`` a voxel of a uniformly chosen present
    foreground class (label > 0) defines a clamped patch-start
    ``margin``; the actual start is then drawn uniformly from
    ``[0, margin]`` per axis (the reference re-randomizes the offset
    below the foreground-centered start rather than centering on it).
    Images smaller than ``crop_shape`` yield the full extent on that
    axis, as upstream.
    """
    crop_shape = _as_triple(crop_shape)
    assert img.ndim == 4 and seg.ndim == 3 and img.shape[1:] == seg.shape

    if keep_foreground:
        voxel = _sample_foreground_voxel(seg, rng)
    else:
        voxel = None
    margins = []
    for ax in range(3):
        limit = max(seg.shape[ax] - crop_shape[ax], 0)
        if voxel is None:
            margins.append(limit)
        else:
            centered = max(0, int(voxel[ax]) - crop_shape[ax] // 2)
            margins.append(max(0, min(limit, centered)))
    starts = [int(rng.integers(0, m + 1)) for m in margins]
    sl = tuple(slice(s, s + c) for s, c in zip(starts, crop_shape))
    return img[(slice(None),) + sl].copy(), seg[sl].copy()


def _sample_foreground_voxel(seg: np.ndarray, rng: np.random.Generator):
    """Uniform voxel from a uniformly chosen present foreground class.

    The reference pre-subsamples each class's locations (≤10k voxels or
    ≥1% coverage) purely to bound memory, then draws uniformly — the
    marginal distribution is uniform over the class's voxels, which is
    what we draw directly.
    """
    classes = [c for c in np.unique(seg) if c != 0]
    if not classes:
        return None
    c = classes[int(rng.integers(len(classes)))]
    locs = np.argwhere(seg == c)
    return locs[int(rng.integers(len(locs)))]


def gaussian_noise_3d(img: np.ndarray, rng: np.random.Generator,
                      prob: float = 0.1, mean: float = 0.0,
                      std: float = 0.1) -> np.ndarray:
    """Additive Gaussian noise with a per-sample random std in [0, std]
    (transforms.py:1646-1654)."""
    assert 0.0 <= prob <= 1.0 and std >= 0.0
    if rng.random() >= prob:
        return img
    rand_std = rng.uniform(0.0, std)
    noise = rng.normal(mean, rand_std, size=img.shape).astype(img.dtype)
    return img + noise


def _draw_sigma(rng: np.random.Generator, sigma_range) -> float:
    lo, hi = sigma_range
    return float(lo) if lo == hi else float(rng.uniform(lo, hi))


def gaussian_blur_3d(img: np.ndarray, rng: np.random.Generator,
                     sigma_range: tuple[float, float] = (0.5, 1.0),
                     prob: float = 0.2, prob_per_channel: float = 0.5,
                     different_sigma_per_channel: bool = True,
                     different_sigma_per_axis: bool = True) -> np.ndarray:
    """Per-modality Gaussian blur with random sigma
    (transforms.py:1729-1755): one sample-level gate, then an
    independent gate per modality; sigma optionally re-drawn per
    modality and/or per spatial axis."""
    assert 0.0 <= prob <= 1.0 and 0.0 <= prob_per_channel <= 1.0
    if rng.random() >= prob:
        return img
    from scipy.ndimage import gaussian_filter

    out = img.copy()
    sigma = None
    for c in range(img.shape[0]):
        if rng.random() < prob_per_channel:
            if sigma is None or different_sigma_per_channel:
                if different_sigma_per_axis:
                    sigma = [_draw_sigma(rng, sigma_range)
                             for _ in img.shape[1:]]
                else:
                    sigma = _draw_sigma(rng, sigma_range)
            out[c] = gaussian_filter(out[c], sigma, order=0)
    return out


def random_gamma_3d(img: np.ndarray, rng: np.random.Generator,
                    prob: float = 0.5,
                    gamma_range: tuple[float, float] = (0.5, 2.0),
                    invert_image: bool = False, per_channel: bool = False,
                    retain_stats: bool = False) -> np.ndarray:
    """Random gamma correction on min-max-normalized intensities
    (transforms.py:1838-1871): gamma < 1 with probability 1/2 (when the
    range allows), optional mean/std restoration, optional sign
    inversion around the power, optional per-modality redraw."""
    assert 0.0 <= prob <= 1.0 and len(gamma_range) == 2
    if rng.random() >= prob:
        return img

    def adjust(x: np.ndarray) -> np.ndarray:
        if retain_stats:
            m, s = x.mean(), x.std()
        if rng.random() < 0.5 and gamma_range[0] < 1:
            gamma = rng.uniform(gamma_range[0], 1.0)
        else:
            gamma = rng.uniform(max(gamma_range[0], 1.0), gamma_range[1])
        mn = x.min()
        span = x.max() - mn
        x = np.power((x - mn) / float(span + 1e-7), gamma) * span + mn
        if retain_stats:
            x = (x - x.mean()) / (x.std() + 1e-8) * s + m
        return x

    out = -img if invert_image else img
    if per_channel:
        out = np.stack([adjust(out[c]) for c in range(out.shape[0])])
    else:
        out = adjust(out)
    return (-out if invert_image else out).astype(img.dtype)


def pad_3d(img: np.ndarray, seg: np.ndarray | None,
           pad_shape, pad_val: float = 0.0, seg_pad_val: int = 0
           ) -> tuple[np.ndarray, np.ndarray | None]:
    """Center-pad to at least ``pad_shape`` (Z, Y, X) with constants
    (transforms.py:1980-2009; X-axis and seg-indexing quirks corrected —
    see module docstring)."""
    pad_shape = _as_triple(pad_shape)
    widths = []
    for ax in range(3):
        d = max(pad_shape[ax] - img.shape[1 + ax], 0)
        widths.append((d // 2, d - d // 2))
    img = np.pad(img, [(0, 0)] + widths, mode="constant",
                 constant_values=pad_val)
    if seg is not None:
        seg = np.pad(seg, widths, mode="constant",
                     constant_values=seg_pad_val)
    return img, seg


def random_flip_3d(img: np.ndarray, seg: np.ndarray | None,
                   rng: np.random.Generator, prob: float,
                   axes: tuple[int, ...],
                   swap_label_pairs: list[tuple[int, int]] | None = None
                   ) -> tuple[np.ndarray, np.ndarray | None]:
    """Independent per-axis flips (Z/Y/X order as the reference's
    0/1/2), with optional label-pair swapping for lateralized anatomy
    (transforms.py:2084-2149)."""
    assert 0.0 <= prob <= 1.0 and (not axes or max(axes) <= 2)
    do = [ax in axes and rng.random() < prob for ax in range(3)]
    flip_axes = tuple(ax for ax in range(3) if do[ax])
    if flip_axes:
        img = np.flip(img, axis=tuple(1 + ax for ax in flip_axes)).copy()
        if seg is not None:
            seg = np.flip(seg, axis=flip_axes).copy()
    if seg is not None and swap_label_pairs is not None:
        out = seg.copy()
        for a, b in swap_label_pairs:
            out[seg == a] = b
            out[seg == b] = a
        seg = out
    return img, seg
