"""The threaded train loader and the eval iterator (port of
``TrainLoader`` and ``eval_batches`` of ``spike2former_tpu/data/loader.py``).

The reference's torch DataLoader runs 16 worker processes per GPU
(configs ...ade20k.py:182); here, as in the JAX package, a producer thread
hands each sample to a thread pool (PIL and numpy release the interpreter
lock for the heavy parts) and keeps a bounded queue of batches ahead of
the device.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .dataset import SegDataset
from .transforms import test_pipeline, train_pipeline, train_pipeline_mix

PREFETCH = 4          # batches queued ahead of the consumer


class TrainLoader:
    """Endless (images [B, H, W, 3] f32, sem_seg [B, H, W] int32) batches
    of ``train_pipeline`` crops, in the JAX package's order: one
    ``np.random.default_rng(seed)`` draws each epoch's permutation and
    then, batch by batch, one seed per sample for that sample's
    transforms, so the same seed and tree give the same batches.

    ``batch_size`` is the per-process batch: every process draws the
    same permutation and takes its ``process_id``-strided share.
    ``mosaic_prob`` > 0 mixes samples with ``train_pipeline_mix``, the
    3 extra samples drawn from the whole dataset by the sample's own
    generator.  Call ``close`` (or use the loader as a context manager)
    to stop the producer and the pool."""

    def __init__(self, dataset: SegDataset, batch_size: int,
                 crop_size=(512, 512), seed: int = 0, num_workers: int = 8,
                 process_id: int = 0, process_count: int = 1,
                 mosaic_prob: float = 0.0):
        self.ds = dataset
        self.bs = batch_size
        self.crop = crop_size
        self.rng = np.random.default_rng(seed)
        self.pid, self.pcount = process_id, process_count
        self.mosaic_prob = mosaic_prob
        self.pool = ThreadPoolExecutor(num_workers)
        self.q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _load_one(self, idx: int, seed: int):
        rng = np.random.default_rng(seed)
        if self.mosaic_prob > 0:
            def extra():
                return self.ds.load(int(rng.integers(len(self.ds))))
            s = train_pipeline_mix(self.ds.load(idx), extra, rng,
                                   self.crop, self.mosaic_prob)
        else:
            s = train_pipeline(self.ds.load(idx), rng, self.crop)
        return s["image"], s["sem_seg"]

    def _put(self, item) -> bool:
        """Queue ``item`` unless ``close`` is called first."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            while not self._stop.is_set():
                order = self.rng.permutation(len(self.ds))
                if self.pcount > 1:
                    order = order[self.pid::self.pcount]
                for i in range(0, len(order) - self.bs + 1, self.bs):
                    idxs = order[i:i + self.bs]
                    seeds = self.rng.integers(0, 2**31, size=self.bs)
                    futs = [self.pool.submit(self._load_one, int(j), int(sd))
                            for j, sd in zip(idxs, seeds)]
                    imgs, segs = zip(*(f.result() for f in futs))
                    batch = (np.stack(imgs).astype(np.float32),
                             np.stack(segs).astype(np.int32))
                    if not self._put(batch):
                        return
        except Exception as e:  # handed to the consumer, raised there
            self._put(e)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            item = self.q.get()
            if isinstance(item, Exception):
                raise RuntimeError("the train loader's producer failed"
                                   ) from item
            yield item

    def close(self) -> None:
        """Stop the producer and the pool; when this returns, neither has
        a thread running."""
        self._stop.set()
        self._thread.join()
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "TrainLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
