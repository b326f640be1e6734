"""The port's eval data layer and IoU metric against the JAX package, on a
tiny ADE20K-layout tree written to ``tmp_path`` by
``torch_port_helpers.write_ade_tree``: the dataset's files, ``eval_batches``'
arrays and metas with bucketed and exact padding at the tiny test scale and
at the flagship's, and the IoU state and scores, all compared exactly."""
import sys
import os

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest

from spike2former_tpu.data import eval_batches as jax_eval_batches
from spike2former_tpu.data import make_dataset as jax_make_dataset
from spike2former_tpu.evaluation import iou_metric as jiou
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.loader import eval_batches
from spike2former_tpu_torch.evaluation import iou_metric as tiou

from torch_port_helpers import write_ade_tree


@pytest.fixture
def ade_root(tmp_path):
    return write_ade_tree(tmp_path / "ade")


def test_dataset_lists_and_loads_what_jax_does(ade_root):
    want = jax_make_dataset("ade20k", ade_root, "val")
    got = make_dataset("ade20k", ade_root, "val")
    assert got.samples == want.samples and len(got) == 4
    for i in range(len(got)):
        w, g = want.load(i), got.load(i)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["sem_seg"], w["sem_seg"])
        assert g["meta"] == w["meta"]
        # reduce_zero_label: 0 (unlabeled) -> 255, k -> k - 1
        assert set(np.unique(g["sem_seg"])) <= {0, 1, 2, 3, 4, 255}


@pytest.mark.parametrize("kw", [dict(scale=(128, 96), bucket=64),
                                dict(scale=(128, 96), bucket=0),
                                dict(scale=(2048, 512), size_divisor=32)])
def test_eval_batches_match_jax(ade_root, kw):
    want = list(jax_eval_batches(jax_make_dataset("ade20k", ade_root, "val"),
                                 **kw))
    got = list(eval_batches(make_dataset("ade20k", ade_root, "val"), **kw))
    assert len(got) == len(want) == 4
    for (gi, gs, gm), (wi, ws, wm) in zip(got, want):
        assert gi.dtype == wi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
        assert gm == wm
        assert gs.shape[1:] == gm[0]["ori_shape"]


def _iou_inputs(seed):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 6, (2, 31, 17)).astype(np.int32)
    label[label == 5] = 255
    pred = rng.integers(0, 5, (2, 31, 17)).astype(np.int32)
    return pred, label


def test_iou_metric_matches_jax_exactly():
    """Two updates, one class absent from both prediction and GT (class
    5: its IoU is nan and left out of the mean), ignore pixels."""
    want_state, got_state = jiou.init_iou(6), tiou.init_iou(6)
    for seed in (0, 1):
        pred, label = _iou_inputs(seed)
        want_state = jiou.update_iou_np(want_state, pred, label, 6)
        got_state = tiou.update_iou_np(got_state, pred, label, 6)
    for g, w in zip(got_state, want_state):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    want, got = jiou.compute_iou(want_state), tiou.compute_iou(got_state)
    assert set(got) == set(want)
    for k in ("mIoU", "mAcc", "aAcc"):
        assert got[k] == want[k]
    np.testing.assert_array_equal(got["IoU"], want["IoU"])
    np.testing.assert_array_equal(got["Acc"], want["Acc"])
    assert np.isnan(got["IoU"][5]) and np.isfinite(got["mIoU"])
