"""Render augmented training samples with their ground truth (the port's
counterpart of the JAX package's ``tools/browse_dataset.py``; mmseg's
tools/misc/browse_dataset.py): ``train_pipeline`` on the first ``--num``
training samples with a generator seeded by ``--seed``, each written as
``sample_{i}_img.png`` and its palette overlay ``sample_{i}_gt.png``.

    python -m spike2former_tpu_torch.tools.browse_dataset CONFIG \\
        --data-root DIR [--out-dir work_dirs/browse] [--num 8] [--seed 0] \\
        [--cfg-options KEY=VALUE ...]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from PIL import Image

from ..data.dataset import make_dataset
from ..data.metainfo import DATASETS
from ..data.transforms import train_pipeline
from ..engine.config import get_config
from ..evaluation.visualize import draw_sem_seg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out-dir", default="work_dirs/browse")
    ap.add_argument("--num", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    cfg = get_config(args.config, args.cfg_options)
    if args.data_root:
        cfg.data.data_root = args.data_root
    ds = make_dataset(cfg.data.dataset, cfg.data.data_root, "train")
    meta = DATASETS[cfg.data.dataset]
    pal = (np.asarray(meta.palette, np.uint8)
           if meta.palette is not None else None)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for i in range(min(args.num, len(ds))):
        sample = train_pipeline(ds.load(i), rng, cfg.data.crop_size)
        img = sample["image"].astype(np.uint8)
        vis = draw_sem_seg(img, sample["sem_seg"].astype(np.int32),
                           palette=pal)
        Image.fromarray(img).save(f"{args.out_dir}/sample_{i}_img.png")
        Image.fromarray(vis).save(f"{args.out_dir}/sample_{i}_gt.png")
        present = sorted(int(v) for v in np.unique(sample["sem_seg"])
                         if v != 255)
        print(f"wrote sample_{i} (classes present: {present})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
