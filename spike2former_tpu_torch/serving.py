"""Micro-batching serving queue around the single-image inference path
(port of ``spike2former_tpu/serving.py``).

``ServingEngine`` takes concurrent single-image requests, groups them by
resolution bucket and runs up to ``max_batch`` of a bucket as one forward:

* each request is resized keeping its ratio to ``data.test_scale`` and
  padded to a multiple of ``bucket`` (``bucket_hw``), on the host of the
  submitting thread, so requests fall into a handful of shapes;
* one worker thread takes the fullest bucket first, waiting once for
  ``wait_ms`` for stragglers when it holds fewer than ``max_batch``;
* the batch runs at its true size: the padded region of each row is
  masked through ``valid_hw`` (``engine/inference.py:whole_logits``);
* each request's logits are cropped to its valid region, resized to its
  original shape and reduced by argmax on the device
  (``postprocess_pred``), and only its ``[H, W]`` int32 class map is
  copied back.

An exception in a batch is set on each of its futures; ``close()`` fails
what is still queued.  ``stats()`` reports the requests served, the
throughput, the p50/p99 latency from submit to result and the histogram
of batch sizes.  Runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .api import InferenceModel, init_model
from .data.transforms import load_image, pad_to, resize_keep_ratio
from .device import f32_precision
from .engine.inference import bucket_hw, postprocess_pred, whole_logits


@dataclass
class _Request:
    image: np.ndarray           # the bucket-padded image
    img_shape: tuple[int, int]  # its valid region inside the bucket
    ori_shape: tuple[int, int]
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)


class ServingEngine:
    """Concurrent single-image segmentation server.

    Usage::

        with ServingEngine("SDTv2_maskformer_DCNpixelDecoder_ade20k",
                           checkpoint=..., max_batch=16) as eng:
            fut = eng.submit(image)        # a concurrent.futures.Future
            pred = fut.result()            # [H, W] int32 class map
            print(eng.stats())

    The model comes from ``init_model(config, checkpoint, overrides,
    device=device)`` (the card unless ``device="cpu"``), or is ``model``,
    an ``InferenceModel``.
    """

    def __init__(self, config: Any = None, checkpoint: str | None = None,
                 overrides: list[str] | None = None, *,
                 model: InferenceModel | None = None,
                 device: str | torch.device | None = None,
                 max_batch: int = 16, bucket: int = 128,
                 max_queue: int = 256, wait_ms: float = 2.0):
        self.im = model if model is not None else init_model(
            config, checkpoint, overrides, device=device)
        self.max_batch = max_batch
        self.bucket = bucket
        self.wait_s = wait_ms / 1e3

        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._pending: dict[tuple[int, int], list[_Request]] = {}
        self._latencies: list[float] = []
        self._batch_sizes: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self._n_done = 0
        self._t_start = time.perf_counter()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- client
    def submit(self, image: str | np.ndarray) -> Future:
        """Enqueue one image (path or RGB array).  Returns a Future that
        resolves to the [H, W] int32 class map at the original
        resolution."""
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is closed")
        img = load_image(image) if isinstance(image, str) else image
        ori_shape = img.shape[:2]
        sample = {"image": img, "sem_seg": None, "meta": {}}
        sample = resize_keep_ratio(sample, *self.im.cfg.data.test_scale)
        h, w = sample["image"].shape[:2]
        sample = pad_to(sample, bucket_hw(h, w, self.bucket))
        req = _Request(sample["image"], (h, w), ori_shape)
        self._q.put(req)
        if self._stop.is_set():     # closed while this one was queued
            self._fail_queued()
        return req.future

    def __call__(self, image) -> np.ndarray:
        return self.submit(image).result()

    def stats(self) -> dict:
        """``requests``, ``throughput`` (requests/s since the engine
        started), ``p50_ms`` and ``p99_ms`` (submit to result) and
        ``batch_sizes`` ({forward batch size: forwards})."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            n = self._n_done
            sizes = dict(sorted(self._batch_sizes.items()))
        dt = time.perf_counter() - self._t_start
        out = {"requests": n, "throughput": n / dt if dt > 0 else 0.0,
               "batch_sizes": sizes}
        if len(lat):
            out["p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["p99_ms"] = float(np.percentile(lat, 99) * 1e3)
        return out

    def close(self):
        """Stop the worker after the batch it is running; every request
        still queued fails with ``RuntimeError``."""
        self._stop.set()
        self._worker.join(timeout=60)
        for reqs in self._pending.values():
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(RuntimeError("engine closed"))
        self._pending.clear()
        self._fail_queued()

    def _fail_queued(self):
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if not r.future.done():
                r.future.set_exception(RuntimeError("engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------------- worker
    def _drain(self):
        """Move queued requests into per-bucket pending lists."""
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            self._pending.setdefault(req.image.shape[:2], []).append(req)

    def _pick_bucket(self):
        """The fullest bucket (the largest batch)."""
        if not self._pending:
            return None
        return max(self._pending, key=lambda k: len(self._pending[k]))

    def _run(self):
        while not self._stop.is_set():
            self._drain()
            key = self._pick_bucket()
            if key is None:
                time.sleep(self.wait_s)
                continue
            # one coalescing wait when the fullest bucket is short
            if len(self._pending[key]) < self.max_batch:
                time.sleep(self.wait_s)
                self._drain()
                key = self._pick_bucket()
            if self._stop.is_set():
                return
            reqs = self._pending[key][:self.max_batch]
            self._pending[key] = self._pending[key][len(reqs):]
            if not self._pending[key]:
                del self._pending[key]
            try:
                self._process(reqs)
            except Exception as e:  # noqa: BLE001 — propagate to callers
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _process(self, reqs: list[_Request]):
        """One forward of ``reqs`` (one bucket) at its true batch size;
        post-processing on the device, one class map copied back per
        request."""
        dev = self.im.device
        batch = torch.from_numpy(np.stack([r.image for r in reqs])).to(dev)
        valid = torch.tensor([r.img_shape for r in reqs], dtype=torch.long)
        with f32_precision(), torch.inference_mode():
            logits = whole_logits(self.im.model, batch, valid_hw=valid)
            preds = [postprocess_pred(logits[i:i + 1], r.img_shape,
                                      r.ori_shape)[0]
                     for i, r in enumerate(reqs)]
        with self._lock:
            self._batch_sizes[len(reqs)] += 1
        for r, pred in zip(reqs, preds):
            r.future.set_result(pred.cpu().numpy())
            with self._lock:
                self._latencies.append(time.perf_counter() - r.t_submit)
                self._n_done += 1
