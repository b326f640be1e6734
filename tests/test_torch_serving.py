"""The port's ``ServingEngine`` against the JAX package's
(``spike2former_tpu/serving.py``, tests/test_serving.py), at tiny dims on
the CPU with the same seeded weights.

Tolerances: the device post-processing's resize within 1e-5 of JAX's host
``_resize_bilinear_np`` (as tests/test_serving.py holds JAX's against its
device resize); each micro-batch's logits within 1e-3 of JAX's
``whole_logits`` on the same padded batch and ``valid_hw`` rows (the
full-model tolerance at tiny dims); the class maps equal to those of JAX's
engine on the same images.
"""
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spike2former_tpu.serving as jserving
from spike2former_tpu.api import InferenceModel as JaxInferenceModel
from spike2former_tpu.engine.config import get_config as jax_get_config
from spike2former_tpu.engine.inference import whole_logits as jax_whole
from spike2former_tpu_torch import serving
from spike2former_tpu_torch.api import InferenceModel
from spike2former_tpu_torch.device import f32_precision
from spike2former_tpu_torch.engine.config import get_config
from spike2former_tpu_torch.engine.inference import postprocess_pred
from spike2former_tpu_torch.ops.resize import resize_bilinear
from spike2former_tpu_torch.serving import ServingEngine

from torch_port_helpers import TINY, make_pair

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()] + [
    "data.test_scale=(128,96)"]


@pytest.fixture(scope="module")
def models():
    """The port's and JAX's InferenceModel with the same weights."""
    jm, variables, pm = make_pair(TINY, seed=2)
    port = InferenceModel(get_config(PRESET, OPTS), pm, torch.device("cpu"))
    jax_im = JaxInferenceModel(jax_get_config(PRESET, OPTS), jm, variables)
    return port, jax_im


def _images(seed=3):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)
            for _ in range(6)]
    imgs += [rng.integers(0, 255, (60, 45, 3)).astype(np.uint8)
             for _ in range(2)]
    imgs += [rng.integers(0, 255, (150, 70, 3)).astype(np.uint8)]
    return imgs


def test_device_postprocess_matches_jax_host_resize():
    """Crop, resize to the original shape and argmax on the device
    (``postprocess_pred``) against JAX's host ``_resize_bilinear_np``."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 1, (1, 32, 48, 7)).astype(np.float32)
    for valid, ori in (((32, 48), (20, 17)), ((27, 40), (96, 131)),
                       ((32, 48), (32, 48))):
        crop = logits[0, :valid[0], :valid[1]]
        want = jserving._resize_bilinear_np(crop, ori)
        got = resize_bilinear(torch.from_numpy(crop[None].copy()), ori)[0]
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        pred = postprocess_pred(torch.from_numpy(logits), valid, ori)[0]
        assert pred.dtype == torch.int32 and tuple(pred.shape) == ori
        assert (pred.numpy() == want.argmax(-1)).mean() >= 0.999


def _recording(monkeypatch):
    """Record each forward's batch, ``valid_hw`` and logits."""
    calls = []
    real = serving.whole_logits

    def record(model, batch, valid_hw=None):
        out = real(model, batch, valid_hw=valid_hw)
        calls.append((batch.numpy().copy(), valid_hw.numpy().copy(),
                      out.numpy().copy()))
        return out

    monkeypatch.setattr(serving, "whole_logits", record)
    return calls


def test_engine_batches_and_each_batch_matches_jax(models, monkeypatch):
    port, jax_im = models
    calls = _recording(monkeypatch)
    imgs = _images()
    with ServingEngine(model=port, max_batch=4, bucket=64,
                       wait_ms=100.0) as eng:
        futs = [eng.submit(im) for im in imgs]
        preds = [f.result(timeout=300) for f in futs]
        st = eng.stats()
    for im, pred in zip(imgs, preds):
        assert pred.shape == im.shape[:2] and pred.dtype == np.int32
        assert 0 <= pred.min() and pred.max() < TINY["num_classes"]
    # micro-batching happened, at true batch sizes
    sizes = [len(b) for b, _, _ in calls]
    assert len(calls) < len(imgs) and max(sizes) > 1, sizes
    assert sum(sizes) == len(imgs)
    assert st["requests"] == len(imgs)
    assert st["batch_sizes"] == {n: sizes.count(n) for n in set(sizes)}
    assert st["p50_ms"] > 0 and st["p99_ms"] >= st["p50_ms"]
    # each batch against JAX's whole_logits on the same rows
    for batch, valid, got in calls:
        want = np.asarray(jax_whole(jax_im.model, jax_im.variables,
                                    jnp.asarray(batch), valid_hw=valid))
        assert np.abs(want).max() > 0.05
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    # some rows are padded: their valid_hw masks the decoder's keys
    assert any((v < b.shape[1:3]).any() for b, v, _ in calls)


def test_class_maps_equal_jax_engine(models):
    port, jax_im = models
    imgs = _images(seed=5)
    with ServingEngine(model=port, max_batch=4, bucket=64,
                       wait_ms=50.0) as eng:
        got = [f.result(timeout=300) for f in [eng.submit(i) for i in imgs]]
    jeng = jserving.ServingEngine(None, model=jax_im, max_batch=4, bucket=64,
                                  wait_ms=50.0)
    try:
        want = [f.result(timeout=300) for f in [jeng.submit(i)
                                                for i in imgs]]
    finally:
        jeng.close()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_concurrent_submitters(models):
    port, _ = models
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 255, (80 + i % 3 * 8, 100, 3)).astype(np.uint8)
            for i in range(8)]
    results, errs = {}, []
    eng = ServingEngine(model=port, max_batch=4, bucket=64, wait_ms=20.0)

    def client(i):
        try:
            for j in range(i, len(imgs), 4):
                results[j] = eng(imgs[j])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    eng.close()
    assert not errs, errs
    assert sorted(results) == list(range(len(imgs)))
    for j, pred in results.items():
        assert pred.shape == imgs[j].shape[:2]
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(imgs[0])
    # one at a time agrees with the concurrent run's maps (the batches
    # the threads' timing made are computed at other batch sizes, where
    # the CPU's convolutions round differently in the last ulp)
    with ServingEngine(model=port, max_batch=1, bucket=64,
                       wait_ms=1.0) as eng1:
        for j, im in enumerate(imgs):
            assert (eng1(im) == results[j]).mean() >= 0.999


def test_close_fails_queued_requests(models, monkeypatch):
    """The batch in flight completes; what is still queued fails."""
    port, _ = models
    started, release = threading.Event(), threading.Event()
    real = serving.whole_logits

    def slow(model, batch, valid_hw=None):
        started.set()
        release.wait(60)
        return real(model, batch, valid_hw=valid_hw)

    monkeypatch.setattr(serving, "whole_logits", slow)
    imgs = _images()
    eng = ServingEngine(model=port, max_batch=1, bucket=64, wait_ms=1.0)
    first = eng.submit(imgs[0])
    assert started.wait(60)
    rest = [eng.submit(im) for im in imgs[1:4]]
    closer = threading.Thread(target=eng.close)
    closer.start()
    release.set()
    closer.join(60)
    assert first.result(timeout=60).shape == imgs[0].shape[:2]
    for f in rest:
        with pytest.raises(RuntimeError, match="engine closed"):
            f.result(timeout=60)


def test_a_failing_batch_sets_its_exception_on_the_futures(models,
                                                           monkeypatch):
    port, _ = models

    def broken(model, batch, valid_hw=None):
        raise ValueError("broken forward")

    monkeypatch.setattr(serving, "whole_logits", broken)
    with ServingEngine(model=port, max_batch=4, bucket=64,
                       wait_ms=20.0) as eng:
        futs = [eng.submit(im) for im in _images()[:3]]
        for f in futs:
            with pytest.raises(ValueError, match="broken forward"):
                f.result(timeout=60)


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_f32_flags_hold_across_threads():
    """A block in one thread keeps TF32 off while another thread's block
    opens and closes; the flags come back when the last block closes."""
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        inside, b_done, seen = threading.Event(), threading.Event(), []

        def a():
            with f32_precision():
                inside.set()
                b_done.wait(30)
                seen.append(_tf32())

        def b():
            inside.wait(30)
            with f32_precision():
                seen.append(_tf32())
            b_done.set()

        ta, tb = threading.Thread(target=a), threading.Thread(target=b)
        ta.start()
        tb.start()
        ta.join(30)
        tb.join(30)
        assert seen == [(False, False), (False, False)]
        assert _tf32() == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_engine_forward_runs_in_f32_beside_a_caller(models, monkeypatch):
    """The worker's forward sees TF32 off whatever the caller's flags, and
    the caller's flags are as it left them after the engine's work."""
    port, _ = models
    seen = []
    real = serving.whole_logits

    def record(model, batch, valid_hw=None):
        seen.append(_tf32())
        return real(model, batch, valid_hw=valid_hw)

    monkeypatch.setattr(serving, "whole_logits", record)
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with ServingEngine(model=port, max_batch=2, bucket=64,
                           wait_ms=1.0) as eng:
            for im in _images()[:3]:
                eng(im)
        assert seen and all(s == (False, False) for s in seen)
        assert _tf32() == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_engine_builds_its_model_from_a_preset():
    with ServingEngine(PRESET, overrides=OPTS, device="cpu", max_batch=2,
                       bucket=64) as eng:
        pred = eng(np.zeros((40, 50, 3), np.uint8))
    assert pred.shape == (40, 50) and eng.im.device.type == "cpu"
