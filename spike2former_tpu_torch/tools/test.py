"""The eval CLI (the port's counterpart of the JAX package's
``tools/test.py``): whole-image or sliding-window inference over the val
split of a dataset in the mmseg layout, scored by mIoU, mAcc and aAcc.

    python -m spike2former_tpu_torch.tools.test CONFIG --data-root DIR \\
        [--checkpoint CKPT | --torch-checkpoint REF.pth] \\
        [--max-images N] [--show-dir DIR] [--cfg-options KEY=VALUE ...] \\
        [--device cpu]

``cfg.test`` picks the mode: ``whole`` pads each resized image to a
multiple of ``test.bucket`` and masks the padding (``valid_hw``), or with
``test.bucket=0`` pads it to ``data.size_divisor`` unmasked; ``slide``
runs ``test.crop_size`` windows at ``test.stride``.  Each prediction is
cut to the image, resized to the original shape and scored against the
annotation at that shape; images without one are skipped.
``--checkpoint`` loads a checkpoint of the train CLI or a state dict of
the port saved by ``torch.save``; ``--torch-checkpoint`` loads a
reference ``EncoderDecoder`` checkpoint and implies ``model.compat=True``;
with neither, the weights are drawn from seed 0.  ``--show-dir`` writes
each prediction's palette overlay at the network's input resolution.
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
from PIL import Image

from ..api import InferenceModel, init_model
from ..data.dataset import SegDataset, make_dataset
from ..data.loader import eval_batches
from ..device import f32_precision
from ..engine.checkpoint import load_reference_model
from ..engine.config import get_config
from ..engine.inference import postprocess_pred, slide_logits, whole_logits
from ..evaluation.iou_metric import compute_iou, init_iou, update_iou_np
from ..evaluation.visualize import draw_sem_seg


def evaluate(im: InferenceModel, dataset: SegDataset,
             max_images: int | None = None, show_dir: str | None = None,
             show_every: int = 1, show_name: str = "pred") -> dict:
    """Score ``im`` on the labelled images of ``dataset`` by
    ``im.cfg.test``'s mode.  Returns ``compute_iou``'s result with
    ``images`` (the count) and ``preds`` (each image's class map at its
    original shape, int32).  With ``show_dir``, every ``show_every``-th
    image's overlay goes to ``show_dir/{show_name}_{i:05d}.png``."""
    cfg, k = im.cfg, im.num_classes
    if cfg.test.mode not in ("whole", "slide"):
        raise ValueError(f"test.mode must be 'whole' or 'slide', got "
                         f"{cfg.test.mode!r}")
    slide = cfg.test.mode == "slide"
    palette = (np.asarray(dataset.meta.palette, np.uint8)
               if dataset.meta.palette else None)
    iou, preds = init_iou(k), []
    with f32_precision():
        for images, sem, metas in eval_batches(
                dataset, scale=cfg.data.test_scale,
                size_divisor=cfg.data.size_divisor,
                bucket=0 if slide else cfg.test.bucket):
            if sem is None:
                continue
            x = torch.from_numpy(images).to(im.device)
            meta = metas[0]
            if slide:
                logits = slide_logits(im.model, x, cfg.test.crop_size,
                                      cfg.test.stride, k)
            else:
                logits = whole_logits(
                    im.model, x,
                    valid_hw=[meta["img_shape"]] if cfg.test.bucket else None)
            pred = postprocess_pred(logits, meta["pad_shape"],
                                    meta["ori_shape"]).cpu().numpy()
            iou = update_iou_np(iou, pred, sem, k)
            if show_dir and len(preds) % show_every == 0:
                os.makedirs(show_dir, exist_ok=True)
                overlay = draw_sem_seg(
                    images[0].astype(np.uint8),
                    logits[0].argmax(-1).to(torch.int32).cpu().numpy(),
                    palette)
                Image.fromarray(overlay).save(os.path.join(
                    show_dir, f"{show_name}_{len(preds):05d}.png"))
            preds.append(pred[0])
            if max_images and len(preds) >= max_images:
                break
    return dict(compute_iou(iou), images=len(preds), preds=preds)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--data-root", default=None)
    ckpt = ap.add_mutually_exclusive_group()
    ckpt.add_argument("--checkpoint", default=None,
                      help="a checkpoint of the train CLI, or a state dict "
                           "of the port saved by torch.save")
    ckpt.add_argument("--torch-checkpoint", default=None,
                      help="reference .pth EncoderDecoder checkpoint, "
                           "read with model.variant's key map; implies "
                           "model.compat=True")
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--show-dir", default=None,
                    help="write prediction overlays (SegVisualizationHook)")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    args = ap.parse_args(argv)

    cfg = get_config(args.config, args.cfg_options)
    if args.data_root:
        cfg.data.data_root = args.data_root
    state_dict = None
    if args.torch_checkpoint:
        cfg.model.compat = True
        m = cfg.model
        state_dict = load_reference_model(
            args.torch_checkpoint, variant=m.variant,
            depths_stage3=m.depths_stage3,
            depths_stage4=m.depths_stage4,
            num_encoder_layers=m.num_encoder_layers,
            num_decoder_layers=m.num_decoder_layers)
    im = init_model(cfg, args.checkpoint, device=args.device,
                    state_dict=state_dict)
    res = evaluate(im, make_dataset(cfg.data.dataset, cfg.data.data_root,
                                    "val"), args.max_images,
                   show_dir=args.show_dir)
    print(f"images: {res['images']}")
    print(f"mIoU {res['mIoU']:.2f}  mAcc {res['mAcc']:.2f}  "
          f"aAcc {res['aAcc']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
