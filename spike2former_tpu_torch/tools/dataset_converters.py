"""Dataset converters (port of the ``cityscapes``, ``coco_stuff`` and
``voc_aug`` subcommands of the JAX package's ``tools/dataset_converters.py``;
mmseg's tools/dataset_converters/*):

  cityscapes  : *_gtFine_labelTrainIds.png beside each gtFine labelId map
  coco_stuff  : COCO-Stuff 182-id labelmaps -> *_labelTrainIds.png (171
                train ids)
  voc_aug     : SBD (benchmark_RELEASE) .mat annotations -> VOC-layout
                SegmentationClassAug PNGs + the trainaug list

    python -m spike2former_tpu_torch.tools.dataset_converters cityscapes \\
        DATA/cityscapes/gtFine
    python -m spike2former_tpu_torch.tools.dataset_converters coco_stuff \\
        DATA/coco_stuff164k/annotations
    python -m spike2former_tpu_torch.tools.dataset_converters voc_aug \\
        DATA/benchmark_RELEASE DATA/VOCdevkit/VOC2012
"""
import argparse
import os
import sys

import numpy as np
from PIL import Image

# Cityscapes labelId -> trainId (255 = ignore), the standard mapping from
# cityscapesscripts labels.py.
CITYSCAPES_LABEL2TRAIN = np.full(256, 255, np.uint8)
for label_id, train_id in [
        (7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6),
        (20, 7), (21, 8), (22, 9), (23, 10), (24, 11), (25, 12), (26, 13),
        (27, 14), (28, 15), (31, 16), (32, 17), (33, 18)]:
    CITYSCAPES_LABEL2TRAIN[label_id] = train_id

# COCO-Stuff 182 ids -> 171 contiguous train ids (11 unused ids removed),
# per mmseg's coco_stuff164k converter.
_COCO_UNUSED = {11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90}


def _coco_lut():
    lut = np.full(256, 255, np.uint8)
    train = 0
    for cid in range(182):
        if cid in _COCO_UNUSED:
            continue
        lut[cid] = train
        train += 1
    return lut


def convert_dir(src_dir, suffix, out_suffix, lut):
    n = 0
    for root, _, files in os.walk(src_dir):
        for f in files:
            if not f.endswith(suffix):
                continue
            path = os.path.join(root, f)
            arr = np.asarray(Image.open(path))
            out = lut[np.clip(arr, 0, 255)]
            out_path = path[: -len(suffix)] + out_suffix
            Image.fromarray(out).save(out_path)
            n += 1
    return n


# --------------------------------------------------------------------------
# voc_aug: SBD .mat -> PNG (ref tools/dataset_converters/voc_aug.py)
# --------------------------------------------------------------------------

def convert_voc_aug(sbd_dir: str, voc_dir: str) -> int:
    """benchmark_RELEASE/dataset/cls/*.mat (GTcls.Segmentation uint8 class
    maps) -> <voc_dir>/SegmentationClassAug/*.png, plus the merged
    ImageSets/Segmentation/trainaug.txt (SBD train+val minus VOC val)."""
    from scipy.io import loadmat

    cls_dir = os.path.join(sbd_dir, "dataset", "cls")
    out_dir = os.path.join(voc_dir, "SegmentationClassAug")
    os.makedirs(out_dir, exist_ok=True)
    names = []
    for f in sorted(os.listdir(cls_dir)):
        if not f.endswith(".mat"):
            continue
        mat = loadmat(os.path.join(cls_dir, f))
        seg = mat["GTcls"]["Segmentation"][0][0].astype(np.uint8)
        stem = f[:-4]
        Image.fromarray(seg).save(os.path.join(out_dir, stem + ".png"))
        names.append(stem)

    sets_dir = os.path.join(voc_dir, "ImageSets", "Segmentation")

    def read_list(name):
        path = os.path.join(sets_dir, name)
        if not os.path.exists(path):
            return []
        with open(path) as fh:
            return [ln.strip() for ln in fh if ln.strip()]

    voc_train = set(read_list("train.txt"))
    voc_val = set(read_list("val.txt"))
    trainaug = sorted((set(names) | voc_train) - voc_val)
    os.makedirs(sets_dir, exist_ok=True)
    with open(os.path.join(sets_dir, "trainaug.txt"), "w") as fh:
        fh.writelines(n + "\n" for n in trainaug)
    return len(names)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cityscapes")
    c.add_argument("gtfine_dir")
    s = sub.add_parser("coco_stuff")
    s.add_argument("ann_dir")
    v = sub.add_parser("voc_aug")
    v.add_argument("sbd_dir")
    v.add_argument("voc_dir")
    args = ap.parse_args(argv)

    if args.cmd == "cityscapes":
        n = convert_dir(args.gtfine_dir, "_gtFine_labelIds.png",
                        "_gtFine_labelTrainIds.png", CITYSCAPES_LABEL2TRAIN)
    elif args.cmd == "coco_stuff":
        n = convert_dir(args.ann_dir, ".png", "_labelTrainIds.png",
                        _coco_lut())
    else:
        n = convert_voc_aug(args.sbd_dir, args.voc_dir)
    print(f"converted {n} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
