"""Image and annotation pairs of a dataset split in the mmseg layout (port
of ``spike2former_tpu/data/dataset.py``; reference:
mmseg/datasets/basesegdataset.py:15-274)."""
from __future__ import annotations

import os
from dataclasses import dataclass

from .metainfo import DATASETS, DatasetMeta
from .transforms import Sample, load_annotation, load_image


@dataclass
class SegDataset:
    """The files of one split: each image under the split's image
    directory, in sorted order, with the annotation of the same stem under
    its annotation directory where one exists (and ``with_ann``).

    ``cache`` decodes each file once and keeps the raw (pre-transform)
    arrays in RAM; the random transforms still differ every epoch.  It
    pays where decoding outcosts the device's step on few host cores."""

    meta: DatasetMeta
    data_root: str
    split: str = "train"
    with_ann: bool = True
    cache: bool = False

    def __post_init__(self):
        self._cache: dict[int, Sample] = {}
        img_dir, ann_dir = self.meta.splits[self.split]
        self.img_dir = os.path.join(self.data_root, img_dir)
        self.ann_dir = os.path.join(self.data_root, ann_dir)
        self.samples: list[tuple[str, str | None]] = []
        for root, _, files in sorted(os.walk(self.img_dir)):
            for f in sorted(files):
                if not f.endswith(self.meta.img_suffix):
                    continue
                stem = f[: -len(self.meta.img_suffix)]
                ann = os.path.join(self.ann_dir,
                                   os.path.relpath(root, self.img_dir),
                                   stem + self.meta.seg_suffix)
                self.samples.append((
                    os.path.join(root, f),
                    ann if self.with_ann and os.path.exists(ann) else None))

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int) -> Sample:
        if self.cache and idx in self._cache:
            c = self._cache[idx]
            return {"image": c["image"], "sem_seg": c["sem_seg"],
                    "meta": dict(c["meta"])}
        img_path, ann_path = self.samples[idx]
        image = load_image(img_path)
        sample = {"image": image,
                  "sem_seg": (load_annotation(ann_path,
                                              self.meta.reduce_zero_label)
                              if ann_path else None),
                  "meta": {"img_path": img_path,
                           "ori_shape": image.shape[:2]}}
        if self.cache:
            self._cache[idx] = {"image": sample["image"],
                                "sem_seg": sample["sem_seg"],
                                "meta": dict(sample["meta"])}
        return sample


def make_dataset(name: str, data_root: str, split: str = "train",
                 **kw) -> SegDataset:
    """The ``split`` of dataset ``name`` under ``data_root``; ``kw`` are
    ``SegDataset``'s ``with_ann`` and ``cache``."""
    return SegDataset(DATASETS[name], data_root, split, **kw)
