"""Confusion matrix over a val split (the port's counterpart of the JAX
package's ``tools/confusion_matrix.py``; mmseg's
tools/analysis_tools/confusion_matrix.py): whole-image inference through
``eval_batches``, ``whole_logits`` and ``postprocess_pred``, a row per
ground-truth class and a column per predicted class, ignore pixels
(255) left out.

    python -m spike2former_tpu_torch.tools.confusion_matrix CONFIG \\
        --data-root DIR [--checkpoint CKPT] [--max-images N] \\
        [--out confusion_matrix.csv] [--cfg-options ...] [--device cpu]

Weights from ``--checkpoint`` (a train checkpoint or a state dict of the
port) or drawn from seed 0.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..api import InferenceModel, init_model
from ..data.dataset import SegDataset, make_dataset
from ..data.loader import eval_batches
from ..device import f32_precision
from ..engine.config import get_config
from ..engine.inference import postprocess_pred, whole_logits


def confusion_matrix(im: InferenceModel, dataset: SegDataset,
                     max_images: int = 50) -> tuple[np.ndarray, int]:
    """The [K, K] int64 matrix over the first ``max_images`` labelled
    images of ``dataset`` and the number of images."""
    k = im.num_classes
    cm = np.zeros((k, k), np.int64)
    n = 0
    with f32_precision():
        for images, sem, metas in eval_batches(
                dataset, scale=im.cfg.data.test_scale,
                size_divisor=im.cfg.data.size_divisor):
            if sem is None:
                continue
            logits = whole_logits(im.model,
                                  torch.from_numpy(images).to(im.device))
            pred = postprocess_pred(logits, metas[0]["pad_shape"],
                                    metas[0]["ori_shape"]).cpu().numpy()
            valid = sem != 255
            idx = sem[valid].astype(np.int64) * k + pred[valid]
            cm += np.bincount(idx, minlength=k * k).reshape(k, k)
            n += 1
            if n >= max_images:
                break
    return cm, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--max-images", type=int, default=50)
    ap.add_argument("--out", default="confusion_matrix.csv")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    cfg = get_config(args.config, args.cfg_options)
    if args.data_root:
        cfg.data.data_root = args.data_root
    im = init_model(cfg, args.checkpoint, device=args.device)
    cm, n = confusion_matrix(
        im, make_dataset(cfg.data.dataset, cfg.data.data_root, "val"),
        args.max_images)
    np.savetxt(args.out, cm, fmt="%d", delimiter=",")
    print(f"{n} images; pixel accuracy "
          f"{np.diag(cm).sum() / max(cm.sum(), 1):.4f}; matrix -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
