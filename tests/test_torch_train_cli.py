"""The port's train CLI on the CPU against the JAX package's train loop, at
tiny dims (``torch_port_helpers.TINY``), 64x64 crops and batch 2 on a
seeded ADE20K-layout tree, from the same seeded weights (converted from
the JAX variables by ``engine/convert.py``).

The JAX side is the loop of ``tools/train.py``: ``make_train_step``
jitted over the JAX ``TrainLoader`` on the same tree and seed, with the
same optimizer recipe.  The ``total`` loss at every logged step agrees
within ``tests/test_torch_train.py``'s ``LOSS_RTOL`` (1e-4).  The files
the CLI writes (retention, ``best/``, ``scalars.jsonl``, overlays),
``--resume`` and the eval CLI on its best checkpoint are checked on the
port alone."""
import sys
import os

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.data import TrainLoader as JaxTrainLoader
from spike2former_tpu.data import make_dataset as jax_make_dataset
from spike2former_tpu.engine import train as jtrain
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.engine.checkpoint import restore_variables
from spike2former_tpu_torch.engine.config import get_config
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.engine.logging import read_scalars
from spike2former_tpu_torch.tools import test as eval_cli
from spike2former_tpu_torch.tools import train as train_cli

from torch_port_helpers import TINY, make_pair, write_ade_tree

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
LOSS_RTOL = 1e-4        # tests/test_torch_train.py
STEPS, LOG = 6, 2
OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()] + [
    "data.crop_size=(64,64)", "data.test_scale=(128,96)", "test.bucket=64",
    "data.batch_size=2", "data.num_workers=2", "train.warmup_iters=2",
    f"train.total_iters={STEPS}", "train.checkpoint_interval=2",
    "train.max_keep_ckpts=2", "train.val_interval=3"]


def _jax_loop(cfg, jm, variables, root):
    """``tools/train.py``'s loop without its checkpoints and val: the
    ``total`` loss at each logged step."""
    t = cfg.train
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = make_optimizer(params, base_lr=t.base_lr,
                        weight_decay=t.weight_decay,
                        backbone_lr_mult=t.backbone_lr_mult,
                        clip_norm=t.clip_norm, warmup_iters=t.warmup_iters,
                        total_iters=t.total_iters)
    state = jtrain.TrainState(
        jnp.zeros((), jnp.int32), params,
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        tx.init(params))
    step = jax.jit(jtrain.make_train_step(
        jm, tx, num_classes=cfg.model.num_classes, max_gt=t.max_gt,
        matcher=t.matcher, loss_at=t.loss_at, compact_gt=t.compact_gt))
    loader = JaxTrainLoader(jax_make_dataset("ade20k", root, "train"),
                            cfg.data.batch_size, cfg.data.crop_size,
                            seed=t.seed, num_workers=cfg.data.num_workers)
    try:
        batches, totals = iter(loader), {}
        for i in range(t.total_iters):
            images, sem = next(batches)
            state, m = step(state, jnp.asarray(images), jnp.asarray(sem))
            if (i + 1) % LOG == 0:
                totals[i + 1] = float(m["total"])
    finally:
        loader.close()
    return totals


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One port CLI run and one JAX loop on the same tree and weights.
    The maps hold classes 0-3 and unlabeled: TINY has 4 queries, and the
    auction assumes no more valid slots than queries."""
    tmp = tmp_path_factory.mktemp("cli")
    root = write_ade_tree(tmp / "ade", n=5, seed=2, num_labels=5)
    cfg = get_config(PRESET, list(OPTS))
    cfg.data.data_root = root
    jm, variables, _ = make_pair(dict(TINY, lazy_masks=True, norm_eval=True),
                                 seed=3)
    work_dir = str(tmp / "wd")
    res = train_cli.train(cfg, work_dir, log_interval=LOG, eval_images=3,
                          vis_interval=2, device="cpu",
                          state_dict=from_jax_variables(variables))
    return dict(res, cfg=cfg, root=root, work_dir=work_dir,
                want=_jax_loop(cfg, jm, variables, root))


def test_logged_losses_match_the_jax_loop(run):
    got = {r["step"]: r["total"] for r in run["logs"]}
    assert sorted(got) == sorted(run["want"]) == [2, 4, 6]
    for step, want in run["want"].items():
        assert np.isfinite(got[step])
        np.testing.assert_allclose(got[step], want, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert len(set(got.values())) == len(got)


def test_cli_writes_its_checkpoints_log_and_overlays(run):
    wd = run["work_dir"]
    assert sorted(os.listdir(wd)) == ["best", "ckpt_4", "ckpt_6",
                                      "scalars.jsonl", "vis"]
    assert sorted(os.listdir(os.path.join(wd, "vis"))) == ["iter_3",
                                                           "iter_6"]
    for it in ("iter_3", "iter_6"):   # 3 val images, every 2nd drawn
        assert sorted(os.listdir(os.path.join(wd, "vis", it))) == [
            "val_00000.png", "val_00002.png"]
    best = os.listdir(os.path.join(wd, "best"))
    assert len(best) == 1 and best[0] in ("ckpt_3", "ckpt_6")
    recs = read_scalars(os.path.join(wd, "scalars.jsonl"))
    assert [r["step"] for r in recs] == [2, 3, 4, 6, 6]
    for r, log in zip([r for r in recs if "total" in r], run["logs"]):
        assert r["total"] == log["total"] and r["sec_per_iter"] > 0
    assert [(r["step"], r["mIoU"]) for r in recs if "mIoU" in r] == [
        tuple(v) for v in run["vals"]]
    # the state at the last step is what the final checkpoint holds
    sd = restore_variables(os.path.join(wd, "ckpt_6"))
    for k, v in run["state"].model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_best_checkpoint_scores_as_the_cli_printed(run, tmp_path, capsys):
    """The eval CLI's ``--checkpoint best/ckpt_N`` in the periodic val's
    mode gives the mIoU that the train CLI logged at step N."""
    wd, cfg = run["work_dir"], run["cfg"]
    (name,) = os.listdir(os.path.join(wd, "best"))
    step = int(name.split("_")[1])
    path = os.path.join(wd, "best", name)
    im = api.init_model(cfg, path, device="cpu")
    res = eval_cli.evaluate(im, make_dataset("ade20k", run["root"], "val"), 3)
    assert res["mIoU"] == dict(run["vals"])[step]
    show = str(tmp_path / "show")
    assert eval_cli.main([PRESET, "--data-root", run["root"], "--checkpoint",
                          path, "--max-images", "3", "--show-dir", show,
                          "--device", "cpu", "--cfg-options", *OPTS]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        f"mIoU {res['mIoU']:.2f}  ")
    assert len(os.listdir(show)) == 3


def test_resume_continues_from_the_newest_checkpoint(run, tmp_path, capsys):
    """``main --resume`` in a copy of the work dir: it restores ckpt_6,
    logs from step 8 on, keeps 2 checkpoints and appends to the log."""
    import shutil

    wd = str(tmp_path / "wd")
    shutil.copytree(run["work_dir"], wd)
    opts = [o for o in OPTS if not o.startswith("train.total_iters")]
    assert train_cli.main([PRESET, "--data-root", run["root"], "--work-dir",
                           wd, "--resume", "--log-interval", "2",
                           "--eval-images", "0", "--device", "cpu",
                           "--cfg-options", *opts,
                           "train.total_iters=8"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"resumed from {wd}/ckpt_6 at step 6"
    assert [line.split()[1] for line in out[1:]] == ["8/8"]
    assert sorted(f for f in os.listdir(wd) if f.startswith("ckpt")) == [
        "ckpt_6", "ckpt_8"]
    recs = read_scalars(os.path.join(wd, "scalars.jsonl"))
    assert [r["step"] for r in recs][-2:] == [6, 8]
    assert np.isfinite(recs[-1]["total"])


def test_val_moves_neither_the_model_nor_the_optimizer(run, tmp_path):
    state = run["state"]
    before = ({k: v.clone() for k, v in state.model.state_dict().items()},
              [t.clone() for t in state.optimizer.mu + state.optimizer.nu],
              state.optimizer.count)
    miou = train_cli.evaluate(run["cfg"], state, torch.device("cpu"), 2)
    assert np.isfinite(miou) and state.model.training
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    for a, b in zip(state.optimizer.mu + state.optimizer.nu, before[1]):
        assert torch.equal(a, b)
    assert state.optimizer.count == before[2]
    cfg = get_config(PRESET, list(OPTS))
    cfg.data.data_root = str(tmp_path)      # no val split: NaN
    assert np.isnan(train_cli.evaluate(cfg, state, torch.device("cpu"), 2))


def test_train_cli_needs_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main([PRESET, "--data-root", str(tmp_path), "--work-dir",
                        str(tmp_path / "wd"), "--cfg-options", *OPTS])
