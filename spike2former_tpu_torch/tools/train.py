"""The train CLI (the port's counterpart of the JAX package's
``tools/train.py``): the flagship's semantic training on a dataset in the
mmseg layout, or panoptic training on a COCO panoptic split
(``data.dataset='coco_panoptic'``), with checkpoints, resume, a scalar
log and periodic val.

    python -m spike2former_tpu_torch.tools.train CONFIG --data-root DIR \\
        [--work-dir DIR] [--resume] [--cfg-options KEY=VALUE ...] \\
        [--log-interval N] [--eval-images N] [--vis-interval N] \\
        [--device cpu]

Batches come from ``data.loader.TrainLoader`` (the ADE20K train pipeline,
seeded by ``train.seed``); weights are drawn from ``train.seed``.  Every
``--log-interval`` steps the metrics are read from the device, printed as
``iter i/N loss ...`` and appended to ``work_dir/scalars.jsonl``; every
``train.checkpoint_interval`` steps the state goes to ``work_dir/ckpt_i``
(``train.max_keep_ckpts`` kept); every ``train.val_interval`` steps
``--eval-images`` val images are scored in whole mode (bucketed by
``test.bucket``), a new best mIoU is saved to ``work_dir/best/`` and, with
``--vis-interval``, overlays go to ``work_dir/vis/iter_i/``.  ``--resume``
continues from the newest checkpoint; as in the JAX package, the loader
restarts from its seed and the best mIoU from -1.  The panoptic run takes
its batches from ``data.panoptic.panoptic_train_batches`` (seeded by
``train.seed``, ``train.max_gt`` segments an image) and, as in the JAX
package, has no periodic val.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import os
import sys
import time

import numpy as np
import torch

from ..api import InferenceModel
from ..data.dataset import make_dataset
from ..data.loader import TrainLoader
from ..data.panoptic import PanopticDataset, panoptic_train_batches
from ..device import f32_precision
from ..engine.checkpoint import latest_checkpoint, restore_state, save_state
from ..engine.config import Config, get_config
from ..engine.logging import ScalarLogger
from ..engine.train import (TrainState, init_trainer, is_panoptic,
                            scaled_base_lr)
from . import test as eval_cli


def evaluate(cfg: Config, state: TrainState, device: torch.device,
             max_images: int, vis_interval: int = 0,
             vis_dir: str | None = None) -> float:
    """Periodic val (mmengine's val loop): the mIoU of the model on the
    first ``max_images`` labelled val images, in whole mode bucketed by
    ``cfg.test.bucket`` whatever ``cfg.test.mode`` says; NaN without val
    images.  The model runs in eval mode and goes back to train mode, so
    neither its BN statistics nor the optimizer move.  ``vis_interval``
    > 0 draws every ``vis_interval``-th prediction into ``vis_dir`` (the
    reference's SegVisualizationHook)."""
    ds = make_dataset(cfg.data.dataset, cfg.data.data_root, "val")
    val_cfg = copy.deepcopy(cfg)
    val_cfg.test.mode = "whole"
    model = state.model.eval()
    try:
        res = eval_cli.evaluate(
            InferenceModel(val_cfg, model, device), ds, max_images,
            show_dir=vis_dir if vis_interval else None,
            show_every=vis_interval or 1, show_name="val")
    finally:
        model.train()
    return res["mIoU"] if res["images"] else float("nan")


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A batch array on ``device``: to the card from pinned memory,
    without blocking the host."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _batch_source(cfg: Config):
    """A context manager over the run's endless batches: the panoptic
    batches of ``panoptic_train_batches``, or a ``TrainLoader`` (its
    threads stop on exit)."""
    t = cfg.train
    if is_panoptic(cfg):
        return contextlib.nullcontext(panoptic_train_batches(
            PanopticDataset(cfg.data.data_root, "train"),
            cfg.data.batch_size, cfg.data.crop_size, t.max_gt, seed=t.seed))
    return TrainLoader(
        make_dataset(cfg.data.dataset, cfg.data.data_root, "train",
                     cache=cfg.data.cache),
        cfg.data.batch_size, cfg.data.crop_size, seed=t.seed,
        num_workers=cfg.data.num_workers, mosaic_prob=cfg.data.mosaic_prob)


def train(cfg: Config, work_dir: str, *, resume: bool = False,
          log_interval: int = 50, eval_images: int = 100,
          vis_interval: int = 0, device: str | torch.device | None = None,
          state_dict: dict[str, torch.Tensor] | None = None) -> dict:
    """The loop of the JAX package's ``tools/train.py``.  Weights come
    from ``state_dict`` when given (loaded strictly), else from
    ``cfg.train.seed``.  Returns the state, the logged metrics
    (``logs``: one dict of floats a log step, with ``step``) and each
    val's mIoU (``vals``: (step, mIoU))."""
    os.makedirs(work_dir, exist_ok=True)
    tr = init_trainer(cfg, device=device, state_dict=state_dict)
    t = cfg.train
    if t.auto_scale_lr:
        print(f"auto_scale_lr: base_lr {t.base_lr} -> {scaled_base_lr(cfg)}",
              flush=True)
    state = tr.state
    if resume:
        ckpt = latest_checkpoint(work_dir)
        if ckpt:
            restore_state(ckpt, state)
            print(f"resumed from {ckpt} at step {state.step}", flush=True)
    start = state.step
    keep = t.max_keep_ckpts or None
    panoptic = is_panoptic(cfg)
    slog = ScalarLogger(work_dir)
    logs, vals, best_miou = [], [], -1.0
    try:
        with _batch_source(cfg) as loader, f32_precision():
            batches = iter(loader)
            t0 = time.time()
            for i in range(start, t.total_iters):
                batch = next(batches)
                if panoptic:  # 0/1 masks: a quarter of the bytes to copy
                    images, labels, masks, valid = batch
                    batch = images, labels, masks.astype(np.uint8), valid
                _, metrics = tr.step_fn(
                    state, *(_to_device(a, tr.device) for a in batch))
                if (i + 1) % log_interval == 0:
                    # one read of the device for all the metrics
                    m = dict(zip(metrics, torch.stack(
                        [v.float() for v in metrics.values()]).tolist()))
                    dt = (time.time() - t0) / log_interval
                    t0 = time.time()
                    parts = " ".join(f"{k.removeprefix('loss_')} {v:.4f}"
                                     for k, v in sorted(m.items())
                                     if k.startswith(("loss_", "acc_")))
                    print(f"iter {i + 1}/{t.total_iters} loss "
                          f"{m['total']:.4f} {parts} {dt:.3f}s/iter",
                          flush=True)
                    slog.log(i + 1, sec_per_iter=dt, **m)
                    logs.append(dict(m, step=i + 1, sec_per_iter=dt))
                if t.checkpoint_interval and (i + 1) % t.checkpoint_interval \
                        == 0:
                    save_state(work_dir, state, i + 1, keep=keep)
                if eval_images and t.val_interval and not panoptic \
                        and (i + 1) % t.val_interval == 0:
                    miou = evaluate(cfg, state, tr.device, eval_images,
                                    vis_interval, os.path.join(
                                        work_dir, "vis", f"iter_{i + 1}"))
                    print(f"iter {i + 1} val mIoU {miou:.2f} "
                          f"(best {best_miou:.2f})", flush=True)
                    slog.log(i + 1, mIoU=miou)
                    vals.append((i + 1, miou))
                    if miou > best_miou:
                        best_miou = miou
                        # save_best='mIoU': best/ is apart from ckpt_*, so
                        # retention and resume never touch it
                        save_state(os.path.join(work_dir, "best"), state,
                                   i + 1, keep=1)
        save_state(work_dir, state, t.total_iters, wait=True, keep=keep)
    finally:
        slog.close()
    return dict(state=state, logs=logs, vals=vals)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", help="preset name (engine/config.py)")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--work-dir", default=None,
                    help="checkpoints, scalars.jsonl, best/ and vis/; "
                         "default work_dirs/CONFIG")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest ckpt_* in --work-dir")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--eval-images", type=int, default=100,
                    help="val images per periodic val (0 disables)")
    ap.add_argument("--vis-interval", type=int, default=0,
                    help="draw every Nth val prediction into "
                         "work_dir/vis/iter_N/ (0 disables)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    args = ap.parse_args(argv)

    cfg = get_config(args.config, args.cfg_options)
    if args.data_root:
        cfg.data.data_root = args.data_root
    train(cfg, args.work_dir or os.path.join(cfg.work_dir, cfg.name),
          resume=args.resume, log_interval=args.log_interval,
          eval_images=args.eval_images, vis_interval=args.vis_interval,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
