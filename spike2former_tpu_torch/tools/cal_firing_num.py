"""Per-spike-site firing statistics (the port's counterpart of the JAX
package's ``tools/cal_firing_num.py``): the first ``--num-images`` val
images, each resized keeping its ratio to (2048, 512), centre-cropped and
padded to ``data.crop_size``, go through the model one at a time; the
per-site ``rate`` (mean output x D) and ``nonfire`` (fraction of zeros),
averaged over the images, are written to ``OUT.json`` and ``OUT.csv``.

    python -m spike2former_tpu_torch.tools.cal_firing_num CONFIG \\
        --data-root DIR [--checkpoint CKPT] [--num-images 200] \\
        [--out firing_rates] [--cfg-options KEY=VALUE ...] [--device cpu]

Like the JAX tool it sets ``model.collapse_t=False`` and
``model.eval_last_only=False``: every time step and every decoder layer
goes through the spike sites, as the reference's hooks see them.
``--checkpoint`` loads a checkpoint of the train CLI or a state dict of
the port saved by ``torch.save``; without it the weights are drawn from
seed 0.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import csv
import json
import sys

import numpy as np
import torch

from ..api import init_model
from ..data.dataset import make_dataset
from ..data.transforms import pad_to, resize_keep_ratio
from ..device import f32_precision
from ..engine.config import get_config
from ..models.segmentor import preprocess
from ..utils.firing import accumulate_firing, energy_proxy


def center_crop(img: np.ndarray, crop: tuple[int, int]) -> np.ndarray:
    """The centre ``crop`` of ``img``, bottom-right padded with 0 where
    the image is smaller."""
    h, w = img.shape[:2]
    y = max((h - crop[0]) // 2, 0)
    x = max((w - crop[1]) // 2, 0)
    out = img[y:y + crop[0], x:x + crop[1]]
    return pad_to({"image": out, "sem_seg": None, "meta": {}},
                  crop)["image"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--num-images", type=int, default=200)
    ap.add_argument("--out", default="firing_rates")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    args = ap.parse_args(argv)

    cfg = get_config(args.config, args.cfg_options)
    if args.data_root:
        cfg.data.data_root = args.data_root
    cfg.model.eval_last_only = False
    cfg.model.collapse_t = False
    im = init_model(cfg, args.checkpoint, device=args.device)
    crop = tuple(cfg.data.crop_size)

    def images():
        ds = make_dataset(cfg.data.dataset, cfg.data.data_root, "val")
        for i in range(min(len(ds), args.num_images)):
            s = resize_keep_ratio(ds.load(i), 2048, 512)
            img = center_crop(s["image"], crop)
            yield preprocess(torch.from_numpy(img[None]).to(im.device))

    with f32_precision():
        rates = accumulate_firing(im.model, images(),
                                  max_images=args.num_images)
    print(f"{len(rates)} spike sites; mean firing rate "
          f"{energy_proxy(rates):.4f}")
    with open(args.out + ".json", "w") as f:
        json.dump(rates, f, indent=2)
    with open(args.out + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["site", "firing_rate"])
        for k, v in sorted(rates.items()):
            w.writerow([k, f"{v:.6f}"])
    print(f"wrote {args.out}.json / {args.out}.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
