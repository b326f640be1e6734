"""The learning run (port of the repository's ``tools/learning_run.sh``):
the flagship trained at bf16 on the structured synthetic set through the
port's train CLI, then its report.

    python -m spike2former_tpu_torch.tools.learning_run [--iters 4000] \\
        [--data-root work_dirs/synthseg] \\
        [--work-dir work_dirs/learning_run_torch] \\
        [--train 2000 --val 200 --size 512 --classes 30 --seed 0] \\
        [--log-interval 50] [--out docs/LEARNING_TORCH.md] \\
        [--png docs/learning_curve_torch.png] [--device cpu] \\
        [--cfg-options KEY=VALUE ...]

Three stages, in one process:

1. ``make_synth_dataset`` writes the set (``--train``/``--val`` images of
   ``--size``, ``--classes`` classes, ``--seed``) where ``--data-root``
   lacks either split.
2. The train CLI (``tools/train.py``) runs ``SDTv2_maskformer_DCNpixel
   Decoder_ade20k`` for ``--iters`` iterations with the options of the
   JAX package's script (``OPTIONS``: bf16, batch 8, lr 6e-4, warmup 300,
   val of 50 images every 500, a checkpoint every 2000, two kept),
   ``model.num_classes`` set to ``--classes``, and ``--cfg-options``
   after them, so they can override any of these.  The card's
   ``nvidia-smi`` name and power limit, this command's arguments, the
   set, the options and the peak device memory go to
   ``work_dir/run_info.json``.
3. ``make_learning_report`` renders ``--out`` (and ``--png``).

Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import torch

from ..device import resolve_device
from . import make_learning_report, make_synth_dataset
from . import train as train_cli

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
# tools/learning_run.sh's --cfg-options, less model.num_classes and
# train.total_iters (--classes and --iters)
OPTIONS = ("model.dtype=bfloat16", "data.batch_size=8",
           "data.num_workers=8", "data.cache=True",
           "data.test_scale=(512,512)", "train.base_lr=0.0006",
           "train.warmup_iters=300", "train.val_interval=500",
           "train.checkpoint_interval=2000", "train.max_keep_ckpts=2")


def has_split(root: str, split: str) -> bool:
    return bool(glob.glob(os.path.join(root, "images", split, "*.jpg")))


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the CPU."""
    if device.type != "cuda":
        return "the CPU (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--data-root", default="work_dirs/synthseg")
    ap.add_argument("--work-dir", default="work_dirs/learning_run_torch")
    ap.add_argument("--train", type=int, default=2000)
    ap.add_argument("--val", type=int, default=200)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--classes", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--out", default="docs/LEARNING_TORCH.md")
    ap.add_argument("--png", default="docs/learning_curve_torch.png")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    given = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(given)
    device = resolve_device(args.device)

    for split, n in (("training", args.train), ("validation", args.val)):
        if not has_split(args.data_root, split):
            make_synth_dataset.write_split(
                args.data_root, split, n, args.size, args.classes,
                args.seed)
            print(f"{split}: {n} images -> {args.data_root}", flush=True)

    options = [*OPTIONS, f"model.num_classes={args.classes}",
               f"train.total_iters={args.iters}", *args.cfg_options]
    os.makedirs(args.work_dir, exist_ok=True)
    info = dict(card=card_line(device), argv=given,
                set=f"{args.classes} classes, {args.train} train / "
                    f"{args.val} val at {args.size}x{args.size}",
                options=options)
    info_path = os.path.join(args.work_dir, make_learning_report.RUN_INFO)

    def write_info():
        with open(info_path, "w") as f:
            json.dump(info, f, indent=1)

    write_info()  # a run cut short still names its card
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    train_argv = [PRESET, "--data-root", args.data_root, "--work-dir",
                  args.work_dir, "--log-interval", str(args.log_interval),
                  "--eval-images", "50", "--vis-interval", "10"]
    if args.device:
        train_argv += ["--device", args.device]
    rc = train_cli.main(train_argv + ["--cfg-options", *options])
    if device.type == "cuda":
        info["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        write_info()
    if rc:
        return rc
    return make_learning_report.main(["--work-dir", args.work_dir,
                                      "--out", args.out, "--png", args.png])


if __name__ == "__main__":
    sys.exit(main())
