"""The eval iterator (port of ``eval_batches`` of
``spike2former_tpu/data/loader.py``)."""
from __future__ import annotations

import numpy as np

from .dataset import SegDataset
from .transforms import test_pipeline


def eval_batches(dataset: SegDataset, scale=(2048, 512),
                 size_divisor: int = 32,
                 bucket: int = 0):
    """Yields, image by image, (images [1, H, W, 3] f32, sem_seg
    [1, oh, ow] int32 or None, metas).

    The image goes through ``test_pipeline``: keep-ratio resize to
    ``scale``, then padding to a multiple of ``bucket`` (pass
    ``meta['img_shape']`` as ``valid_hw`` to ``whole_logits`` so the
    padding is masked) or of ``size_divisor``.  As the reference scores
    (``BaseSegmentor.postprocess_result``), ``sem_seg`` is the annotation
    at the original resolution, and the metas carry ``ori_shape``, the
    resized ``img_shape`` and ``pad_shape`` (the region of the padded
    input that holds the image) for ``postprocess_pred``."""
    for i in range(len(dataset)):
        raw = dataset.load(i)
        ori_shape = raw["image"].shape[:2]
        ori_seg = raw.pop("sem_seg", None)
        s = test_pipeline(raw, scale, size_divisor=size_divisor,
                          bucket=bucket)
        img = s["image"][None].astype(np.float32)
        seg = None if ori_seg is None else ori_seg[None].astype(np.int32)
        meta = dict(s["meta"], ori_shape=ori_shape)
        meta.setdefault("pad_shape", meta["img_shape"])
        yield img, seg, [meta]
