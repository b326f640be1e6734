"""The port's panoptic path against the JAX package's: the COCO-panoptic
data (id PNGs, dataset, GT conversion, train batches), the PQ metric, the
merge, ``whole_panoptic``, the panoptic train step and both CLIs, on
seeded COCO-panoptic-layout trees (``data/synthetic.py``) at tiny dims.

Tolerances: the data, the metric, ``slot_map_from_masks`` and the merge
exactly (ints, or the same float sums); ``whole_panoptic``'s class and
mask logits at 1e-3 (the end-to-end tolerance of
``tests/test_full_model_parity.py``) and its maps on >= 0.999 of the
pixels; the train step at ``tests/test_torch_train.py``'s tolerances.

Random weights make a flat class head: every query's top probability
stays near 1/(K+1), below any threshold, and the merge returns all void.
So ``whole_panoptic`` and the eval CLI run on weights drawn as
``torch_port_helpers.randomize_variables`` draws them with three changes,
the same on both sides: the query features at std 2 (so the queries
differ), the class head's kernel x8 (confident queries) and the last
mask-embedding kernel x32 (masks that saturate), and ``whole_panoptic``
at ``object_mask_thr=0.5``; the maps are checked to hold kept queries
and, at ``compat=False``, both thing instances and stuff.
"""
import argparse
import contextlib
import importlib.util
import io
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.data import panoptic as jpan
from spike2former_tpu.engine import train as jtrain
from spike2former_tpu.engine.config import get_config as jax_get_config
from spike2former_tpu.engine.inference import whole_panoptic as jax_whole
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu.evaluation import panoptic as jpq
from spike2former_tpu.evaluation.tta import \
    panoptic_inference as jax_panoptic_inference
from spike2former_tpu.losses.criterion import \
    slot_map_from_masks as jax_slot_map
from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu_torch import api
from spike2former_tpu_torch.data import panoptic as tpan
from spike2former_tpu_torch.data.synthetic import (confident_merge_inputs,
                                                   write_coco_panoptic_tree)
from spike2former_tpu_torch.engine import train as ttrain
from spike2former_tpu_torch.engine.config import TrainConfig, get_config
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.engine.inference import whole_panoptic
from spike2former_tpu_torch.evaluation import panoptic as tpq
from spike2former_tpu_torch.evaluation.tta import panoptic_inference
from spike2former_tpu_torch.losses.criterion import slot_map_from_masks
from spike2former_tpu_torch.models.segmentor import preprocess
from spike2former_tpu_torch.tools import test as eval_cli
from spike2former_tpu_torch.tools import train as train_cli

from test_torch_train import (_check_grads, _check_metrics, _check_state,
                              _recording)
from torch_port_helpers import TINY, make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "SDTv2_maskformer_coco_panoptic"
NUM_THINGS, NUM_STUFF = 2, 2
NUM_CLASSES = NUM_THINGS + NUM_STUFF
# 8 queries: the auction assumes no more valid GT segments than queries,
# and a crop holds up to 2 stuff and 4 thing segments
CFG = dict(TINY, num_classes=NUM_CLASSES, num_queries=8)
MAX_GT, CROP, BATCH = 8, (64, 64), 2
TREE_SHAPES = ((96, 128), (128, 96), (90, 120))
OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in CFG.items()] + [
    f"model.num_things={NUM_THINGS}", "data.crop_size=(64,64)",
    "data.test_scale=(128,96)", "test.bucket=64", f"data.batch_size={BATCH}",
    "train.warmup_iters=1", "train.total_iters=2", f"train.max_gt={MAX_GT}",
    "train.checkpoint_interval=0"]


@pytest.fixture(scope="module")
def pan_root(tmp_path_factory):
    """A tiny COCO-panoptic tree: 3 train and 3 val images, 2 thing and 2
    stuff categories, a crowd and a VOID box in every image."""
    root = str(tmp_path_factory.mktemp("coco_pan"))
    for split, seed in (("train", 1), ("val", 0)):
        write_coco_panoptic_tree(root, TREE_SHAPES, seed=seed, split=split,
                                 num_things=NUM_THINGS, num_stuff=NUM_STUFF,
                                 instances=(2, 4))
    return root


def test_png_id_round_trip_matches_jax():
    ids = np.random.default_rng(0).integers(0, 2 ** 24, (7, 9))
    ids[0, :4] = (0, 255, 65535, 2 ** 24 - 1)
    rgb = tpan.encode_pan_png(ids)
    np.testing.assert_array_equal(rgb, jpan.encode_pan_png(ids))
    np.testing.assert_array_equal(tpan.decode_pan_png(rgb), ids)
    np.testing.assert_array_equal(tpan.decode_pan_png(rgb),
                                  jpan.decode_pan_png(rgb))


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_and_gt_conversion_match_jax(pan_root, split):
    """Contiguous labels (things first), each sample, its padded segments
    at two ``max_gt`` (one cutting segments off) and its PQ maps."""
    got, want = (tpan.PanopticDataset(pan_root, split),
                 jpan.PanopticDataset(pan_root, split))
    for k in ("num_things", "num_stuff", "num_classes", "classes",
              "cat2contig", "anns"):
        assert getattr(got, k) == getattr(want, k), k
    assert (got.num_things, got.num_stuff) == (NUM_THINGS, NUM_STUFF)
    crowds = 0
    for i in range(len(got)):
        g, w = got.load(i), want.load(i)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["pan_ids"], w["pan_ids"])
        assert g["segments"] == w["segments"] and g["meta"] == w["meta"]
        crowds += sum(c for _, _, c in g["segments"])
        for max_gt in (MAX_GT, 3):
            for a, b in zip(
                    tpan.panoptic_to_instances(g["pan_ids"], g["segments"],
                                               max_gt, NUM_THINGS),
                    jpan.panoptic_to_instances(w["pan_ids"], w["segments"],
                                               max_gt, NUM_THINGS)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for a, b in zip(tpan.panoptic_maps(g["pan_ids"], g["segments"]),
                        jpan.panoptic_maps(w["pan_ids"], w["segments"])):
            np.testing.assert_array_equal(a, b)
    assert crowds == len(got)


def test_train_batches_are_bit_identical_to_jax(pan_root):
    got = tpan.panoptic_train_batches(tpan.PanopticDataset(pan_root),
                                      BATCH, CROP, MAX_GT, seed=3)
    want = jpan.panoptic_train_batches(jpan.PanopticDataset(pan_root),
                                       BATCH, CROP, MAX_GT, seed=3)
    for _ in range(2):
        g, w = next(got), next(want)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert g[3].any() and g[2].dtype == np.float32


def _pq_cases():
    """(pred_label, pred_inst, gt_label, gt_inst, gt_crowd, K): random
    maps, and the void and crowd cases of tests/test_panoptic.py."""
    rng = np.random.default_rng(0)
    cases = []

    def blocks(a):
        return np.kron(a, np.ones((4, 4), a.dtype))

    for _ in range(4):
        gl, gi = rng.integers(-1, 4, (6, 8)), rng.integers(0, 3, (6, 8))
        pl = np.where(rng.uniform(size=gl.shape) < 0.7, gl,
                      rng.integers(-1, 4, gl.shape))
        pi = np.where(rng.uniform(size=gl.shape) < 0.8, gi, 5)
        cases.append((blocks(pl), blocks(pi), blocks(gl), blocks(gi),
                      blocks(rng.uniform(size=gl.shape) < 0.1), 4))
    z, o = np.zeros((4, 4), np.int32), np.ones((4, 4), np.int32)
    part = np.full((4, 4), -1, np.int32)
    part[:, :3] = 0
    cases.append((part, np.where(part == 0, 5, 0), z, o, None, 2))
    top = np.full((4, 4), -1, np.int32)
    top[:1] = 0
    cases.append((top, np.where(top == 0, 9, 0), z, o, None, 2))
    cases.append((z, o, np.full((4, 4), -1, np.int32), z, None, 2))
    cases.append((z, o, z, o, np.ones((4, 4), bool), 2))
    return cases


def test_pq_matches_jax():
    got_stat, want_stat = tpq.PQStat(4), jpq.PQStat(4)
    for pl, pi, gl, gi, crowd, k in _pq_cases():
        g = tpq.pq_update(tpq.PQStat(k), pl, pi, gl, gi, crowd)
        w = jpq.pq_update(jpq.PQStat(k), pl, pi, gl, gi, crowd)
        for f in ("iou", "tp", "fp", "fn"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        if k == 4:
            tpq.pq_update(got_stat, pl, pi, gl, gi, crowd)
            jpq.pq_update(want_stat, pl, pi, gl, gi, crowd)
    got, want = (tpq.compute_pq(got_stat, num_things=2),
                 jpq.compute_pq(want_stat, num_things=2))
    assert got_stat.tp.sum() and got_stat.fp.sum() and got_stat.fn.sum()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_slot_map_from_masks_matches_jax():
    """Overlapping masks (the first valid slot wins), invalid slots and
    uncovered pixels (slot G)."""
    rng = np.random.default_rng(0)
    masks = (rng.uniform(size=(3, 6, 10, 12)) < 0.3).astype(np.float32)
    valid = rng.uniform(size=(3, 6)) < 0.7
    want = np.asarray(jax_slot_map(jnp.asarray(masks), jnp.asarray(valid)))
    for m in (masks, masks.astype(np.uint8)):
        got = slot_map_from_masks(torch.from_numpy(m),
                                  torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(got, want)
    assert (want == 6).any() and len(np.unique(want)) > 3


def test_panoptic_inference_matches_jax():
    cls, masks = confident_merge_inputs()
    for thr in (0.8, 0.5):
        want = jax_panoptic_inference(jnp.asarray(cls), jnp.asarray(masks),
                                      object_mask_thr=thr, num_things=2)
        got = panoptic_inference(torch.from_numpy(cls),
                                 torch.from_numpy(masks),
                                 object_mask_thr=thr, num_things=2)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        sem, inst = (g.numpy() for g in got)
        assert (sem == -1).any() and (sem >= 2).any()     # void and stuff
        assert len(np.unique(inst[inst > 0])) >= 2        # thing instances
        assert ((sem >= 2) == (inst == 0))[sem >= 0].all()


def _confident_pair(compat, seed=6):
    """The tiny panoptic model pair on the weights of the module
    docstring."""
    jm, variables, pm = make_pair(cfg=dict(CFG, num_decoder_layers=2),
                                  compat=compat, seed=seed)
    head = variables["params"]["head"]
    head["query_feat"] = np.random.default_rng(100 + seed).normal(
        0, 2.0, head["query_feat"].shape).astype(np.float32)
    head["cls_embed"]["kernel"] = head["cls_embed"]["kernel"] * 8
    dense = head["mask_embed"]["Dense_2"]
    dense["kernel"] = dense["kernel"] * 32
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm


@pytest.mark.parametrize("compat", [False, True])
def test_whole_panoptic_matches_jax(compat):
    jm, variables, pm = _confident_pair(compat)
    x = np.random.default_rng(6).integers(0, 256, (2, 96, 128, 3),
                                          dtype=np.uint8)
    cls_w, masks_w = jax.jit(lambda v, a: jm.apply(v, a, False))(
        variables, jnp.asarray(np.asarray(preprocess(torch.from_numpy(x)))))
    with torch.no_grad():
        cls_g, masks_g = pm(preprocess(torch.from_numpy(x)))
    np.testing.assert_allclose(cls_g.numpy(), np.asarray(cls_w), atol=1e-3)
    np.testing.assert_allclose(masks_g.numpy(), np.asarray(masks_w),
                               atol=1e-3)
    want = jax_whole(jm, variables, jnp.asarray(x.astype(np.float32)),
                     num_things=NUM_THINGS, object_mask_thr=0.5)
    got = whole_panoptic(pm, torch.from_numpy(x), num_things=NUM_THINGS,
                         object_mask_thr=0.5)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).mean() >= 0.999
    sem, inst = (g.numpy() for g in got)
    assert (sem >= 0).any()
    if not compat:
        assert (inst > 0).any() and (sem >= NUM_THINGS).any()


# --- the panoptic train step -------------------------------------------------

def _jax_batches(root, n=2):
    it = jpan.panoptic_train_batches(jpan.PanopticDataset(root, "train"),
                                     BATCH, CROP, MAX_GT, seed=0)
    return [next(it) for _ in range(n)]


def _run_jax_step(jm, variables, batches, matcher):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = _recording(make_optimizer(params, warmup_iters=1, total_iters=2))
    state = jtrain.TrainState(
        jnp.zeros((), jnp.int32), params,
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        tx.init(params))
    step = jax.jit(jtrain.make_train_step_panoptic(
        jm, tx, num_classes=NUM_CLASSES, matcher=matcher, loss_at="gt",
        compact_gt=32))
    metrics, grads = [], []
    for batch in batches:
        state, m = step(state, *(jnp.asarray(a) for a in batch))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[1]))
    final = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return metrics, grads, final


def _run_port_step(pm, batches, matcher):
    state = ttrain.init_state(pm, TrainConfig(warmup_iters=1, total_iters=2))
    step = ttrain.make_train_step_panoptic(NUM_CLASSES, matcher=matcher,
                                           loss_at="gt", compact_gt=32)
    metrics, grads = [], []
    for images, labels, masks, valid in batches:
        # the masks as the train CLI sends them: 0/1 in uint8
        state, m = step(state, torch.from_numpy(images),
                        torch.from_numpy(labels),
                        torch.from_numpy(masks.astype(np.uint8)),
                        torch.from_numpy(valid))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
    return metrics, grads, {k: v.clone() for k, v in pm.state_dict().items()}


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "compat"])
def step_run(request, pan_root):
    """Two steps of JAX's panoptic step and the port's on the same
    batches and weights, with the host matcher.  JAX's step runs in
    float64: at these weights the first step's gradients reach 3e4, and
    JAX's float32 ``grad_norm`` is 7.5e-4 off (32350.66 against the
    port's 32375.05, whose float64 run reads 32375.05; 8.4e-3 at weight
    seed 0), the one-pass BN variance's rounding that
    ``models/layers.py:BatchNorm`` describes.  JAX's auction does not run
    in float64 (its loop carries float32 prices); the port's auction is
    held to JAX's in ``test_torch_train.py`` and
    ``test_torch_matcher.py``."""
    compat = request.param
    cfg = dict(CFG, lazy_masks=True, norm_eval=True)
    _, variables, pm = make_pair(cfg=cfg, compat=compat, seed=3)
    batches = _jax_batches(pan_root)
    with jax.enable_x64(True):
        jm = JaxSpike2Former(T=1, compat=compat, dtype=jnp.float64, **cfg)
        want = _run_jax_step(jm, jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables), batches,
            "host")
    return dict(compat=compat, variables=variables, batches=batches,
                want=want, got=_run_port_step(pm, batches, "host"))


def test_panoptic_train_step_matches_jax(step_run):
    (want, wgrads, wstate), (got, ggrads, gstate) = (step_run["want"],
                                                     step_run["got"])
    _check_metrics(want, got)
    assert "dropped_gt" not in got[0] and "d0.loss_dice" in got[0]
    for w, g in zip(wgrads, ggrads):
        _check_grads(w, g)
    _check_state(wstate, gstate, wgrads[-1])
    valid = step_run["batches"][0][3]
    assert valid.sum(1).max() <= CFG["num_queries"] and valid.any(1).all()


def test_train_cli_matches_the_jax_step(step_run, pan_root, tmp_path):
    """The port's train CLI, two iterations on the tree with the host
    matcher, logs the totals of JAX's step over JAX's batches
    (``tools/train.py`` seeds ``panoptic_train_batches`` with
    ``train.seed``), takes no val and writes its final checkpoint."""
    cfg = get_config(PRESET, OPTS + ["train.matcher='host'",
                                     f"model.compat={step_run['compat']}"])
    cfg.data.data_root = pan_root
    res = train_cli.train(cfg, str(tmp_path), log_interval=1, eval_images=2,
                          device="cpu",
                          state_dict=from_jax_variables(
                              step_run["variables"]))
    got = [r["total"] for r in res["logs"]]
    want = [m["total"] for m in step_run["want"][0]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert res["vals"] == [] and sorted(os.listdir(tmp_path)) == [
        "ckpt_2", "scalars.jsonl"]


def test_init_trainer_takes_panoptic_batches(pan_root):
    """``api.init_trainer`` on the panoptic preset builds the panoptic
    step, and ``api.train_steps`` takes the 4-array batches."""
    tr = api.init_trainer(PRESET, OPTS, device="cpu", seed=1)
    it = tpan.panoptic_train_batches(tpan.PanopticDataset(pan_root), BATCH,
                                     CROP, MAX_GT, seed=0)
    (m,) = api.train_steps(tr, [next(it)])
    assert np.isfinite(m["total"]) and "dropped_gt" not in m
    assert tr.state.step == 1


# --- the eval CLI ------------------------------------------------------------

def _jax_eval_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_test", os.path.join(ROOT, "tools", "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_cli_matches_jax(pan_root):
    """The port's eval CLI and JAX's ``evaluate_panoptic`` on the same
    weights and tree print the same PQ line, and JAX's metric on the
    port's maps gives the port's PQ."""
    jm, variables, pm = _confident_pair(False)
    opts = [o for o in OPTS if "num_decoder_layers" not in o] + [
        "model.num_decoder_layers=2"]
    cfg = get_config(PRESET, opts)
    cfg.data.data_root = pan_root
    im = api.init_model(cfg, device="cpu",
                        state_dict=from_jax_variables(variables))
    res = eval_cli.evaluate_panoptic(
        im, tpan.PanopticDataset(pan_root, "val"), max_images=None)
    jcfg = jax_get_config(PRESET, opts)
    jcfg.data.data_root = pan_root
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _jax_eval_cli().evaluate_panoptic(
            jcfg, jm, variables, jpan.PanopticDataset(pan_root, "val"),
            argparse.Namespace(max_images=None))
    want_line = buf.getvalue().strip().splitlines()[-1]
    got_line = (f"PQ {res['PQ']:.2f}  SQ {res['SQ']:.2f}  "
                f"RQ {res['RQ']:.2f}  PQ_th {res['PQ_th']:.2f}  "
                f"PQ_st {res['PQ_st']:.2f}")
    assert got_line == want_line and res["images"] == 3
    ds = jpan.PanopticDataset(pan_root, "val")
    stat = jpq.PQStat(NUM_CLASSES)
    for i, (sem, inst) in enumerate(res["maps"]):
        s = ds.load(i)
        assert sem.shape == inst.shape == s["pan_ids"].shape
        jpq.pq_update(stat, sem, inst,
                      *jpan.panoptic_maps(s["pan_ids"], s["segments"]))
    want = jpq.compute_pq(stat, num_things=NUM_THINGS)
    for k in ("PQ", "SQ", "RQ", "PQ_th", "PQ_st"):
        np.testing.assert_array_equal(res[k], want[k])
    assert any((sem >= 0).any() for sem, _ in res["maps"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert eval_cli.main([PRESET, "--device", "cpu", "--data-root",
                              pan_root, "--max-images", "2",
                              "--cfg-options", *OPTS]) == 0
    out = buf.getvalue().splitlines()
    assert out[0] == "images: 2" and out[1].startswith("PQ ")
