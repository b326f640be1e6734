"""Loading a reference-format checkpoint into the port, and the port's eval
CLI, against the JAX package.

The reference checkpoint is ``tests/torch_golden.py``'s
``GoldenSpike2Former`` (the reference's state dict key format) saved as
``{"state_dict": ...}`` with ``torch.save``: the port's
``load_reference_model`` must load it strictly into a ``compat=True``
model whose logits match JAX's ``load_reference_model`` plus its
``compat=True`` model, and the golden itself, at atol/rtol 1e-3
(tests/test_full_model_parity.py's tolerance) at up to 128^2.

The CLI runs on a tiny ADE20K-layout tree on the CPU in whole (bucketed and
exact) and slide modes; its class maps and mIoU/mAcc/aAcc must equal
those of the JAX package's eval pipeline (``tools/test.py``'s functions)
on the same weights.
"""
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.data import eval_batches as jax_eval_batches
from spike2former_tpu.data import make_dataset as jax_make_dataset
from spike2former_tpu.engine import inference as jinf
from spike2former_tpu.engine.checkpoint import (
    load_reference_model as jax_load_reference_model)
from spike2former_tpu.evaluation import iou_metric as jiou
from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu_torch.api import init_model
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.engine.checkpoint import load_reference_model
from spike2former_tpu_torch.engine.config import get_config
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models.segmentor import Spike2Former
from spike2former_tpu_torch.tools import test as cli

from torch_golden import GoldenSpike2Former, randomize_torch
from torch_port_helpers import TINY, make_pair, write_ade_tree

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
TOL = 1e-3
# tests/test_full_model_parity.py's golden dims
CFG = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
           feat_channels=16, num_queries=4, num_decoder_layers=2,
           num_encoder_layers=2, depths_stage3=1, depths_stage4=1,
           dcn_group=4)
DEPTHS = dict(depths_stage3=1, depths_stage4=1, num_encoder_layers=2,
              num_decoder_layers=2)


def _opts(cfg, test_scale=(128, 96)):
    return ([f"model.{k}={v!r}".replace(" ", "") for k, v in cfg.items()]
            + [f"data.test_scale={test_scale!r}".replace(" ", "")])


@pytest.fixture(scope="module")
def golden_pth(tmp_path_factory):
    golden = GoldenSpike2Former(
        num_classes=CFG["num_classes"], embed_dim=CFG["embed_dim"],
        heads=CFG["backbone_heads"], T=1, feat=CFG["feat_channels"],
        num_queries=CFG["num_queries"], dec_layers=CFG["num_decoder_layers"],
        enc_layers=CFG["num_encoder_layers"], group=CFG["dcn_group"],
        depths_stage3=CFG["depths_stage3"],
        depths_stage4=CFG["depths_stage4"])
    randomize_torch(golden, seed=3)
    path = str(tmp_path_factory.mktemp("ref") / "golden.pth")
    torch.save({"state_dict": golden.state_dict(), "meta": {"epoch": 1}},
               path)
    return golden, path


def test_reference_loader_gives_jax_state_strictly(golden_pth):
    """Every port key from the reference keys, equal to the JAX loader's
    variables carried over by ``from_jax_variables``; a strict load."""
    _, path = golden_pth
    sd = load_reference_model(path, **DEPTHS)
    want = from_jax_variables(jax_load_reference_model(path, **DEPTHS))
    assert set(sd) == set(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], atol=0, rtol=0)
    pm = Spike2Former(T=1, compat=True, **CFG)
    res = pm.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys


def test_reference_loader_rejects_keys_nothing_takes(golden_pth, tmp_path):
    golden, _ = golden_pth
    sd = dict(golden.state_dict())
    sd["decode_head.transformer_decoder.post_norm.weight"] = torch.ones(16)
    path = str(tmp_path / "extra.pth")
    torch.save({"state_dict": sd}, path)
    with pytest.raises(KeyError, match="taken by no part of the model"):
        load_reference_model(path, **DEPTHS)


class HistoryBuffer:
    """Stands for mmengine's ``HistoryBuffer``: a class the loader cannot
    import, as in a published checkpoint's ``meta.message_hub``."""

    def __init__(self, values):
        self.values = values


CALLS = []


def _record_call(*args):
    CALLS.append(args)
    return args


class _RunsOnLoad:
    def __reduce__(self):
        return _record_call, ("unpickled",)


def test_reference_loader_reads_an_mmengine_checkpoint(golden_pth, tmp_path):
    """A checkpoint in mmengine's CheckpointHook layout (a ``meta`` with
    numpy scalars, a message hub of objects of classes the loader cannot
    import, optimizer state) loads through ``load_reference_model`` to
    the same state dict as the bare one; nothing pickled in it runs."""
    golden, path = golden_pth
    sd = golden.state_dict()
    ckpt = {"meta": {"epoch": np.int64(3), "iter": 8000,
                     "seed": np.int32(0), "lr": np.float64(1e-4),
                     "message_hub": {"log_scalars": {
                         "train/loss": HistoryBuffer([np.float32(1.5)])}},
                     "hook": _RunsOnLoad()},
            "state_dict": sd,
            "optimizer": {"state": {0: {"step": torch.tensor(8000.0)}},
                          "param_groups": [{"lr": 1e-4, "params": [0]}]}}
    mm_path = str(tmp_path / "mmengine.pth")
    torch.save(ckpt, mm_path)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(mm_path, weights_only=True)
    CALLS.clear()
    got = load_reference_model(mm_path, **DEPTHS)
    assert not CALLS
    want = load_reference_model(path, **DEPTHS)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


def test_reference_loader_refuses_an_object_in_the_state_dict(golden_pth,
                                                              tmp_path):
    """A state dict entry that is not a tensor is named, not run."""
    golden, _ = golden_pth
    sd = dict(golden.state_dict())
    sd["backbone.extra"] = _RunsOnLoad()
    bad = str(tmp_path / "bad.pth")
    torch.save({"state_dict": sd}, bad)
    CALLS.clear()
    with pytest.raises(ValueError, match="backbone.extra is a "
                       "test_torch_checkpoint._record_call"):
        load_reference_model(bad, **DEPTHS)
    assert not CALLS


@pytest.mark.parametrize("hw", [(32, 32), (64, 32), (128, 128)])
def test_reference_checkpoint_logits_match_jax_and_golden(golden_pth, hw):
    golden, path = golden_pth
    pm = Spike2Former(T=1, compat=True, **CFG).eval()
    pm.load_state_dict(load_reference_model(path, **DEPTHS), strict=True)
    jm = JaxSpike2Former(T=1, compat=True, **CFG)
    jvars = jax_load_reference_model(path, **DEPTHS)
    x = np.random.default_rng(0).normal(0, 1, (1, *hw, 3)).astype(np.float32)
    with torch.no_grad():
        cls_p, mask_p = pm(torch.from_numpy(x))
        cls_g, mask_g = golden(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    cls_j, mask_j = jax.jit(lambda v, x: jm.apply(v, x, False))(
        jvars, jnp.asarray(x))
    assert (np.abs(mask_g[-1].numpy()) > 1e-6).mean() > 0.2, "degenerate"
    for want_cls, want_mask in (
            (np.asarray(cls_j[-1]), np.asarray(mask_j[-1])),
            (cls_g[-1].numpy(), mask_g[-1].numpy())):
        np.testing.assert_allclose(cls_p[-1].numpy(), want_cls, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(mask_p[-1].numpy(), want_mask, atol=TOL,
                                   rtol=TOL)


# ---- the eval CLI -----------------------------------------------------------

def _jax_pipeline(jm, variables, root, cfg):
    """tools/test.py's loop with the JAX package's functions."""
    slide = cfg.test.mode == "slide"
    iou, preds = jiou.init_iou(cfg.model.num_classes), []
    for images, sem, metas in jax_eval_batches(
            jax_make_dataset("ade20k", root, "val"),
            scale=cfg.data.test_scale, size_divisor=cfg.data.size_divisor,
            bucket=0 if slide else cfg.test.bucket):
        if slide:
            logits = jinf.slide_logits(jm, variables, jnp.asarray(images),
                                       cfg.test.crop_size, cfg.test.stride,
                                       cfg.model.num_classes)
        else:
            valid = [metas[0]["img_shape"]] if cfg.test.bucket else None
            logits = jinf.whole_logits(jm, variables, jnp.asarray(images),
                                       valid_hw=valid)
        meta = metas[0]
        pred = np.asarray(jinf.postprocess_pred(
            logits, meta.get("pad_shape"), meta["ori_shape"]))
        iou = jiou.update_iou_np(iou, pred, sem, cfg.model.num_classes)
        preds.append(pred[0])
    return dict(jiou.compute_iou(iou), preds=preds)


def _cli(args, capsys):
    assert cli.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("images: ")
    return out[-2:]


MODES = {"whole_bucketed": ["test.bucket=64"],
         "whole_exact": ["test.bucket=0"],
         "slide": ["test.mode='slide'", "test.crop_size=(64,64)",
                   "test.stride=(48,48)"]}


# compat=True (~55 s of JAX compiles) runs with --runslow: the CLI on a
# compat model stays in the default suite through the reference test below
@pytest.mark.parametrize("compat", [
    False, pytest.param(True, marks=pytest.mark.slow)])
@pytest.mark.parametrize("mode", list(MODES))
def test_eval_cli_matches_the_jax_pipeline(mode, compat, tmp_path, capsys):
    root = write_ade_tree(tmp_path / "ade")
    jm, variables, pm = make_pair(TINY, compat=compat, seed=1)
    sd_path = str(tmp_path / "port.pt")
    torch.save(pm.state_dict(), sd_path)
    opts = _opts(dict(TINY, compat=compat)) + MODES[mode]
    cfg = get_config(PRESET, list(opts))
    want = _jax_pipeline(jm, variables, root, cfg)

    res = cli.evaluate(init_model(cfg, state_dict=pm.state_dict(),
                                  device="cpu"),
                       make_dataset("ade20k", root, "val"))
    assert res["images"] == 4
    for g, w in zip(res["preds"], want["preds"]):
        np.testing.assert_array_equal(g, w)
    for k in ("mIoU", "mAcc", "aAcc"):
        assert res[k] == want[k]
    lines = _cli([PRESET, "--data-root", root, "--checkpoint", sd_path,
                  "--device", "cpu", "--cfg-options", *opts], capsys)
    assert lines == ["images: 4", f"mIoU {want['mIoU']:.2f}  mAcc "
                     f"{want['mAcc']:.2f}  aAcc {want['aAcc']:.2f}"]


def test_eval_cli_with_a_reference_checkpoint(golden_pth, tmp_path, capsys):
    """``--torch-checkpoint`` implies ``model.compat=True`` and loads the
    reference keys: the JAX pipeline on JAX's loader gives the same
    scores; ``--max-images`` stops early."""
    _, path = golden_pth
    root = write_ade_tree(tmp_path / "ade")
    opts = _opts(CFG)
    cfg = get_config(PRESET, list(opts))
    jm = JaxSpike2Former(T=1, compat=True, **CFG)
    want = _jax_pipeline(jm, jax_load_reference_model(path, **DEPTHS), root,
                         cfg)
    lines = _cli([PRESET, "--data-root", root, "--torch-checkpoint", path,
                  "--device", "cpu", "--cfg-options", *opts], capsys)
    assert lines == ["images: 4", f"mIoU {want['mIoU']:.2f}  mAcc "
                     f"{want['mAcc']:.2f}  aAcc {want['aAcc']:.2f}"]
    assert _cli([PRESET, "--data-root", root, "--torch-checkpoint", path,
                 "--device", "cpu", "--max-images", "2",
                 "--cfg-options", *opts], capsys)[0] == "images: 2"
