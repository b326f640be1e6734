"""The port's ``evaluation/tta.py:tta_logits``, ``api.Inferencer``, the
Cityscapes labelId writer and ``evaluation/cityscapes_metric.py`` against
the JAX package's, mirroring tests/test_api_tta_viz.py.

Tolerances: ``tta_logits`` within 1e-5 of JAX's on the same predictor
(flip, scales 0.5/1.0/1.5), and within test_torch_model.py's 1e-3 with
each package's own tiny model; the Inferencer's class maps equal; the
Cityscapes metric's numbers equal.
"""
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spike2former_tpu.api import Inferencer as JaxInferencer
from spike2former_tpu.api import InferenceModel as JaxInferenceModel
from spike2former_tpu.engine.config import get_config as jax_get_config
from spike2former_tpu.evaluation import cityscapes_metric as jcm
from spike2former_tpu.evaluation.tta import tta_logits as jax_tta
from spike2former_tpu.evaluation.visualize import (
    write_cityscapes_pred as jax_write_cityscapes_pred)
from spike2former_tpu_torch.api import Inferencer
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.evaluation.cityscapes_metric import (
    CityscapesEval, evaluate_cityscapes_dir)
from spike2former_tpu_torch.evaluation.tta import tta_logits
from spike2former_tpu_torch.evaluation.visualize import (
    CITYSCAPES_TRAIN2LABEL, draw_sem_seg, write_cityscapes_pred)

from torch_port_helpers import TINY, images, make_pair

SCALES = (0.5, 1.0, 1.5)


def test_tta_flip_consistency():
    """A flip-equivariant predictor: TTA equals the plain prediction."""
    def predict(x):
        return torch.stack([x[..., 0], -x[..., 0]], -1)

    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, 10, 3)).astype(np.float32))
    np.testing.assert_allclose(
        tta_logits(predict, imgs, scales=(1.0,), flip=True).numpy(),
        predict(imgs).numpy(), atol=1e-6)


def test_tta_multiscale_shape():
    out = tta_logits(lambda x: torch.zeros(*x.shape[:3], 5),
                     torch.zeros(1, 16, 16, 3), scales=SCALES)
    assert out.shape == (1, 16, 16, 5)


@functools.lru_cache(maxsize=None)
def _pair(compat):
    """The tiny model pair and the JAX model's jitted ``predict_logits``
    (one per mode for the module, so each shape compiles once)."""
    jm, variables, pm = make_pair(TINY, compat=compat, seed=4)
    fn = jax.jit(lambda v, x: jm.apply(
        v, x, method=type(jm).predict_logits))
    return (lambda x: fn(variables, x)), pm


def test_tta_logits_matches_jax_on_one_predictor():
    """The same predictor (the JAX model) under both TTAs: flip x scales
    (0.5, 1.0, 1.5) on a 64x48 image, within 1e-5."""
    jax_predict, _ = _pair(False)
    x = images((64, 48), seed=2)
    want = np.asarray(jax_tta(jax_predict, jnp.asarray(x), SCALES, True))

    def predict(t):
        return torch.from_numpy(np.array(jax_predict(jnp.asarray(
            t.numpy()))))

    got = tta_logits(predict, torch.from_numpy(x), SCALES, True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("compat", [False, True])
def test_tta_logits_with_the_port_model_matches_jax(compat):
    """Each package's own model under its own TTA (the flip at scale 1:
    one JAX compile a mode)."""
    jax_predict, pm = _pair(compat)
    x = images((64, 48), seed=3)
    want = np.asarray(jax_tta(jax_predict, jnp.asarray(x), (1.0,), True))
    with torch.no_grad():
        got = tta_logits(pm.predict_logits, torch.from_numpy(x), (1.0,),
                         True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_inferencer_matches_jax(tmp_path):
    """One image path and two arrays through both Inferencers on the same
    weights: equal class maps, overlays under JAX's names, 150 classes."""
    overrides = ([f"model.{k}={v!r}".replace(" ", "")
                  for k, v in TINY.items()]
                 + ["data.crop_size=(64,64)", "data.test_scale=(96,64)"])
    jm, variables, _ = make_pair(TINY, seed=8)
    # JAX's Inferencer on these weights, without its op-by-op model.init
    jinf = JaxInferencer.__new__(JaxInferencer)
    jinf.im = JaxInferenceModel(
        jax_get_config("SDTv2_maskformer_DCNpixelDecoder_ade20k", overrides),
        jm, jax.tree_util.tree_map(jnp.asarray, variables))
    inf = Inferencer("SDTv2_maskformer_DCNpixelDecoder_ade20k",
                     overrides=overrides, device="cpu",
                     state_dict=from_jax_variables(variables))
    rng = np.random.default_rng(0)
    path = str(tmp_path / "street.jpg")
    Image.fromarray(rng.integers(0, 255, (50, 70, 3), np.uint8)).save(path)
    items = [path] + [rng.integers(0, 255, (70, 90, 3)).astype(np.uint8)
                      for _ in range(2)]
    want = jinf(items, out_dir=str(tmp_path / "jax"))
    got = inf(items, out_dir=str(tmp_path / "port"))
    assert len(got["predictions"]) == 3
    for g, w in zip(got["predictions"], want["predictions"]):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    names = [os.path.basename(p) for p in got["visualization"]]
    assert names == [os.path.basename(p) for p in want["visualization"]]
    assert names == ["street_pred.png", "img_1_pred.png", "img_2_pred.png"]
    for p, q in zip(got["visualization"], want["visualization"]):
        np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                      np.asarray(Image.open(q)))
    assert len(inf.classes) == 150
    single = inf(items[1])
    np.testing.assert_array_equal(single["predictions"][0],
                                  got["predictions"][1])
    assert single["visualization"] == []


def test_draw_sem_seg_and_cityscapes_writer(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    seg = np.asarray([[0, 1, 2, 255]] * 4, np.int32)
    out = draw_sem_seg(img, seg)
    assert out.shape == img.shape
    np.testing.assert_array_equal(out[:, 3], img[:, 3])
    pred = np.random.default_rng(1).integers(-1, 21, (9, 7)).astype(np.int32)
    p = write_cityscapes_pred(pred, str(tmp_path / "a" / "pred.png"))
    q = jax_write_cityscapes_pred(pred, str(tmp_path / "b" / "pred.png"))
    ids = np.asarray(Image.open(p))
    np.testing.assert_array_equal(ids, np.asarray(Image.open(q)))
    assert ids[pred == 0][0] == 7   # road trainId 0 -> labelId 7


def test_cityscapes_official_protocol(tmp_path):
    """Hand-computed IoUs, void-GT exclusion and the directory protocol
    (test_api_tta_viz.py::test_cityscapes_official_protocol)."""
    gt = np.full((8, 8), 7, np.uint8)
    gt[:, 4:] = 23
    gt[0, :] = 0
    pred_train = np.zeros((8, 8), np.int32)
    pred_train[:, 4:] = 10
    pred_train[:, 6:] = 0
    ev = CityscapesEval()
    ev.update(CITYSCAPES_TRAIN2LABEL[pred_train], gt)
    res = ev.compute()
    np.testing.assert_allclose(res["classes"]["road"], 100 * 28 / 42)
    np.testing.assert_allclose(res["classes"]["sky"], 50.0)

    pdir, gdir = tmp_path / "pred", tmp_path / "gt" / "val" / "city"
    os.makedirs(gdir)
    write_cityscapes_pred(pred_train,
                          str(pdir / "val" / "city" / "x_leftImg8bit.png"))
    Image.fromarray(gt).save(gdir / "x_gtFine_labelIds.png")
    out = evaluate_cityscapes_dir(str(pdir), str(tmp_path / "gt"))
    assert out["images"] == 1
    np.testing.assert_allclose(out["classes"]["sky"], 50.0)
    want = jcm.evaluate_cityscapes_dir(str(pdir), str(tmp_path / "gt"))
    assert out.keys() == want.keys() and out["images"] == want["images"]
    np.testing.assert_array_equal(list(out["classes"].values()),
                                  list(want["classes"].values()))
    ev2 = CityscapesEval()
    ev2.update(gt, gt)
    assert ev2.compute()["mIoU"] == 100.0


def test_cityscapes_eval_matches_jax_on_seeded_maps():
    """Random labelId maps, some predictions outside the 19 classes: the
    same confusion matrix, IoUs, mIoU and aAcc."""
    rng = np.random.default_rng(3)
    ids = np.asarray([0, 1, 7, 8, 11, 23, 24, 26, 33, 255], np.uint8)
    ev, jev = CityscapesEval(), jcm.CityscapesEval()
    for _ in range(3):
        p = ids[rng.integers(0, len(ids), (32, 48))]
        g = ids[rng.integers(0, len(ids), (32, 48))]
        ev.update(p, g)
        jev.update(p, g)
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    got, want = ev.compute(), jev.compute()
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["mIoU"], want["mIoU"])
    np.testing.assert_allclose(got["aAcc"], want["aAcc"])
    np.testing.assert_allclose(list(got["classes"].values()),
                               list(want["classes"].values()))
