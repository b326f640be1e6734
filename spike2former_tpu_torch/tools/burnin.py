"""Training burn-in (port of the repository's ``tools/burnin.py``): a long
synthetic-data run of the real train step, with checkpoints, a simulated
crash and resume, and a periodic val, recording the loss and
gradient-norm stability.

    python -m spike2former_tpu_torch.tools.burnin [--steps N] \\
        [--batch-size B] [--accum-steps K] [--image-size S] \\
        [--num-classes C] [--T T] [--dtype bfloat16|float32] \\
        [--packed-residuals] [--ckpt-every N] [--resume-at N] \\
        [--val-every N] [--log-every N] [--work-dir DIR] [--device cpu] \\
        [--tiny]

The model is ``Spike2Former(num_classes, T, dtype)`` at the module's own
defaults (``lazy_masks=False`` among them, where the presets set True),
or at tiny widths with ``--tiny``; its weights are drawn by flax's laws
from seed 0 (``engine/weights.py:init_weights_``, where the JAX tool calls
``model.init(PRNGKey(0))``).  The optimizer is ``engine/optim.py``'s AdamW at
its defaults (lr 1e-3, weight decay 0.005, backbone x0.1, clip 0.01) with
``warmup_iters=min(500, steps // 10)`` and ``total_iters=steps``; the step
is ``make_train_step(num_classes, max_gt=64, accum_steps=K)`` at its
defaults (the auction, ``loss_at='gt'``, ``compact_gt=32``).

Synthetic task: blocky class maps rendered into float images (class id ->
gray level + noise, not rounded), a pool of 16 batches from
``default_rng(0)`` staged on the device and cycled, so that the run times
the step and not host-to-device copies.  Every ``--log-every`` steps the
loss and gradient norm go to ``work_dir/burnin.jsonl`` (``{"step",
"loss", "grad_norm", "sec"}``; ``sec`` since the pool was staged); every
``--ckpt-every`` steps the state goes to ``work_dir/ckpt_<step>``
(``engine/checkpoint.py``, written in the background); every
``--val-every`` steps the pixel accuracy of ``whole_logits`` on two
images from ``default_rng(42)`` is logged as ``{"step", "val_acc"}``.
At ``--resume-at`` the live state is thrown away and the newest
checkpoint restored into a fresh state (weights from seed 1): its step,
parameters, BN statistics, AdamW moments and count (so the schedule),
and the run goes on from that step, so the steps since the checkpoint run
and are logged twice.  The last line printed is one JSON object:
``steps``, ``wall_min``, ``img_per_sec`` (``steps`` times the batch over
the whole wall time), ``loss_first10%``, ``loss_last10%``,
``grad_norm_max``, ``resumed_mid_run``, ``all_finite``.  Runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import f32_precision, resolve_device
from ..engine.checkpoint import (latest_checkpoint, restore_state,
                                 save_state, wait_for_saves)
from ..engine.config import compute_dtype
from ..engine.inference import whole_logits
from ..engine.optim import AdamW
from ..engine.train import TrainState, make_train_step
from ..engine.weights import init_weights_
from ..models.segmentor import Spike2Former

TINY_KW = dict(embed_dim=(8, 16, 24, 32), backbone_heads=4,
               feat_channels=16, num_queries=4, num_decoder_layers=1,
               num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
               dcn_group=4)
POOL = 16          # batches staged on the device
VAL_SEED = 42


def synth_batch(rng, b, hw, num_classes, cells=4):
    """(images [b, hw, hw, 3] float32, sem [b, hw, hw] int32): a
    ``cells`` x ``cells`` grid of classes, each a gray level plus noise."""
    base = rng.integers(0, num_classes, (b, cells, cells))
    sem = np.kron(base, np.ones((hw // cells, hw // cells),
                                np.int64)).astype(np.int32)
    gray = (sem.astype(np.float32) / num_classes) * 200.0 + 25.0
    img = gray[..., None] + rng.normal(0, 12, (b, hw, hw, 3))
    return np.clip(img, 0, 255).astype(np.float32), sem


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--num-classes", type=int, default=150)
    ap.add_argument("--T", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--packed-residuals", action="store_true",
                    help="packed 4-bit spike residuals (ops/spike_op.py)")
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--resume-at", type=int, default=0,
                    help="simulate a failure at this step: rebuild state "
                         "from the latest checkpoint and continue")
    ap.add_argument("--val-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--work-dir", default=os.path.join("work_dirs",
                                                       "burnin"))
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model (CI smoke; seconds instead of minutes)")
    return ap


def build_model(args) -> Spike2Former:
    """The tool's model: the module's defaults, ``--tiny``'s widths."""
    return Spike2Former(num_classes=args.num_classes, T=args.T,
                        dtype=compute_dtype(args.dtype),
                        packed_residuals=args.packed_residuals,
                        **(TINY_KW if args.tiny else {}))


def new_state(args, device: torch.device, seed: int,
              state_dict: dict[str, torch.Tensor] | None = None
              ) -> TrainState:
    """A fresh model (weights from ``state_dict``, loaded strictly, or
    drawn by flax's laws from ``seed``, as the JAX tool's ``model.init``)
    and AdamW on ``device``."""
    model = build_model(args)
    if state_dict is None:
        init_weights_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(device)
    opt = AdamW(model.named_parameters(),
                warmup_iters=min(500, args.steps // 10),
                total_iters=args.steps)
    return TrainState(model, opt)


def val_accuracy(model: torch.nn.Module, args, device: torch.device
                 ) -> float:
    """Pixel accuracy of the model's whole-image prediction on
    ``min(batch, 2)`` synthetic images of ``default_rng(VAL_SEED)``."""
    vimg, vsem = synth_batch(np.random.default_rng(VAL_SEED),
                             min(args.batch_size, 2), args.image_size,
                             args.num_classes)
    model.eval()
    try:
        logits = whole_logits(model, torch.from_numpy(vimg).to(device))
    finally:
        model.train()
    pred = logits.argmax(-1)
    return float((pred == torch.from_numpy(vsem).to(device)).float().mean())


def run(args, state_dict: dict[str, torch.Tensor] | None = None) -> dict:
    """The burn-in of ``args`` (``parser()``'s namespace); weights from
    ``state_dict`` when given, else seed 0.  Returns ``summary`` (the
    JSON line's dict), ``state`` (the final ``TrainState``) and
    ``resumed_from`` (the checkpoint restored, or None)."""
    device = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)
    hw = args.image_size
    rng = np.random.default_rng(0)
    state = new_state(args, device, 0, state_dict)
    step_fn = make_train_step(args.num_classes, max_gt=64,
                              accum_steps=args.accum_steps)
    pool = []
    for _ in range(POOL):
        images, sem = synth_batch(rng, args.batch_size, hw,
                                  args.num_classes)
        pool.append((torch.from_numpy(images).to(device),
                     torch.from_numpy(sem).to(device)))
    losses, gnorms = [], []
    resumed_from = None
    metrics = None
    with open(os.path.join(args.work_dir, "burnin.jsonl"), "a") as log, \
            f32_precision():
        def record(rec):
            log.write(json.dumps(rec) + "\n")
            log.flush()

        t0 = time.perf_counter()
        i = 0
        while i < args.steps:
            if args.resume_at and i == args.resume_at and not resumed_from:
                # simulate a crash: throw the live state away, restore the
                # newest checkpoint (one still being written included)
                wait_for_saves()
                ckpt = latest_checkpoint(args.work_dir)
                if ckpt is None:
                    raise RuntimeError(f"no checkpoint in {args.work_dir} "
                                       f"to resume from at step {i}")
                state = None
                state = restore_state(ckpt, new_state(args, device, 1))
                i = state.step
                resumed_from = ckpt
                print(f"[burnin] simulated failure: resumed from {ckpt} "
                      f"at step {i}", flush=True)
            images, sem = pool[i % len(pool)]
            state, metrics = step_fn(state, images, sem)
            i += 1
            if i % args.log_every == 0:
                total, gnorm = torch.stack(
                    [metrics["total"].float(),
                     metrics["grad_norm"].float()]).tolist()
                losses.append(total)
                gnorms.append(gnorm)
                record({"step": i, "loss": total, "grad_norm": gnorm,
                        "sec": round(time.perf_counter() - t0, 3)})
                print(f"[burnin] step {i}/{args.steps} loss {total:.3f} "
                      f"gnorm {gnorm:.3f}", flush=True)
                if not np.isfinite(total):
                    raise FloatingPointError(f"non-finite loss at step {i}")
            if i % args.ckpt_every == 0:
                save_state(args.work_dir, state, i)
            if args.val_every and i % args.val_every == 0:
                acc = val_accuracy(state.model, args, device)
                print(f"[burnin] step {i} synthetic val pixel-acc "
                      f"{acc:.3f}", flush=True)
                record({"step": i, "val_acc": acc})
        wait_for_saves()
        dt = time.perf_counter() - t0
    if not losses:  # steps < log_every: summarize from the final metrics
        losses.append(float(metrics["total"]))
        gnorms.append(float(metrics["grad_norm"]))
    n = max(len(losses) // 10, 1)
    summary = {
        "steps": args.steps,
        "wall_min": round(dt / 60, 1),
        "img_per_sec": round(args.steps * args.batch_size / dt, 2),
        "loss_first10%": round(float(np.mean(losses[:n])), 3),
        "loss_last10%": round(float(np.mean(losses[-n:])), 3),
        "grad_norm_max": round(float(np.max(gnorms)), 3),
        "resumed_mid_run": resumed_from is not None,
        "all_finite": bool(np.isfinite(losses).all()),
    }
    return dict(summary=summary, state=state, resumed_from=resumed_from)


def main(argv: list[str] | None = None) -> int:
    out = run(parser().parse_args(argv))
    print(json.dumps(out["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
