"""Dataset converters (port of the JAX package's
``tools/dataset_converters.py``; mmseg's tools/dataset_converters/*):

  cityscapes      : *_gtFine_labelTrainIds.png beside each gtFine labelId
                    map
  coco_stuff      : COCO-Stuff 182-id labelmaps -> *_labelTrainIds.png
                    (171 train ids)
  voc_aug         : SBD (benchmark_RELEASE) .mat annotations -> VOC-layout
                    SegmentationClassAug PNGs + the trainaug list
  pascal_context  : Detail trainval_merged.json -> SegmentationClassContext
                    PNGs + split lists (mmseg pascal_context.py), with the
                    RLE decoding here (no detail-api or pycocotools)
  events          : raw event arrays -> T-binned 2-channel count frames as
                    .npy in the DDD17 / ADE layout (the voxelization step of
                    the prophesee converters, pro_gen1.py:24-120)

    python -m spike2former_tpu_torch.tools.dataset_converters cityscapes \\
        DATA/cityscapes/gtFine
    python -m spike2former_tpu_torch.tools.dataset_converters coco_stuff \\
        DATA/coco_stuff164k/annotations
    python -m spike2former_tpu_torch.tools.dataset_converters voc_aug \\
        DATA/benchmark_RELEASE DATA/VOCdevkit/VOC2012
    python -m spike2former_tpu_torch.tools.dataset_converters \\
        pascal_context DATA/trainval_merged.json DATA/VOCdevkit/VOC2010
    python -m spike2former_tpu_torch.tools.dataset_converters events \\
        RAW_EVENTS DATA/ddd17/images/training [--height 200 --width 352
        --t-bins 4]
"""
import argparse
import json
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


# --------------------------------------------------------------------------
# pascal_context: Detail JSON -> PNG (ref pascal_context.py) — the 60-class
# mapping table is the reference's _mapping (:11-18); RLE decoding is
# implemented here so the detail-api / pycocotools are not needed.
# --------------------------------------------------------------------------

PASCAL_CONTEXT_MAPPING = np.sort(np.array([
    0, 2, 259, 260, 415, 324, 9, 258, 144, 18, 19, 22, 23, 397, 25, 284,
    158, 159, 416, 33, 162, 420, 454, 295, 296, 427, 44, 45, 46, 308, 59,
    440, 445, 31, 232, 65, 354, 424, 68, 326, 72, 458, 34, 207, 80, 355,
    85, 347, 220, 349, 360, 98, 187, 104, 105, 366, 189, 368, 113, 115]))


def decode_rle(rle: dict) -> np.ndarray:
    """COCO-style RLE -> [H, W] uint8 mask (column-major runs).  Handles
    both uncompressed (counts: list) and compressed (counts: LEB128-style
    string, the pycocotools rleFrString scheme)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        nums = []
        i = 0
        while i < len(counts):
            x, k, more = 0, 0, True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(nums) > 2:
                x += nums[-2]
            nums.append(x)
        counts = nums
    mask = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        if val:
            mask[pos:pos + run] = 1
        pos += run
        val ^= 1
    return mask.reshape(w, h).T  # column-major


def convert_pascal_context(json_path: str, voc_dir: str,
                           out_dir: str | None = None) -> int:
    """trainval_merged.json -> <voc_dir>/SegmentationClassContext/*.png +
    ImageSets/SegmentationContext/{train,val}.txt.  Per image, annotation
    masks are painted with their (mapped) category id — the detail-api
    ``getMask`` + ``_class_to_index`` flow of the reference converter."""
    out_dir = out_dir or os.path.join(voc_dir, "SegmentationClassContext")
    os.makedirs(out_dir, exist_ok=True)
    with open(json_path) as fh:
        data = json.load(fh)

    cat_ok = set(int(x) for x in PASCAL_CONTEXT_MAPPING)
    images = {im["image_id"] if "image_id" in im else im["id"]: im
              for im in data["images"]}
    annos = data.get("annos_segmentation", data.get("annotations", []))
    by_image: dict = {}
    for a in annos:
        by_image.setdefault(a["image_id"], []).append(a)

    lists: dict[str, list[str]] = {}
    n = 0
    for img_id, im in images.items():
        h, w = im["height"], im["width"]
        full = np.zeros((h, w), np.int32)
        for a in by_image.get(img_id, []):
            cid = int(a["category_id"])
            if cid not in cat_ok:
                continue  # categories outside the 59+bg subset -> background
            m = decode_rle(a["segmentation"]).astype(bool)
            full[m] = cid
        # raw category ids -> contiguous 0..59 via the sorted mapping
        idx = np.digitize(full.ravel(), PASCAL_CONTEXT_MAPPING,
                          right=True).astype(np.uint8)
        out = idx.reshape(h, w)
        stem = os.path.splitext(os.path.basename(im["file_name"]))[0]
        Image.fromarray(out).save(os.path.join(out_dir, stem + ".png"))
        lists.setdefault(im.get("phase", im.get("split", "train")),
                         []).append(stem)
        n += 1

    sets_dir = os.path.join(voc_dir, "ImageSets", "SegmentationContext")
    os.makedirs(sets_dir, exist_ok=True)
    for phase, stems in lists.items():
        name = "train.txt" if str(phase) in ("train", "1") else "val.txt"
        with open(os.path.join(sets_dir, name), "a") as fh:
            fh.writelines(s + "\n" for s in sorted(stems))
    return n


# --------------------------------------------------------------------------
# events: raw event arrays -> binned count frames (pro_gen1.py equivalent)
# --------------------------------------------------------------------------

def voxelize_events(events: np.ndarray, hw: tuple[int, int], t_bins: int
                    ) -> np.ndarray:
    """[N, 4] (t, x, y, polarity) events -> [T, H, W, 2] per-bin
    positive/negative count frames (the quantization_size binning of
    pro_gen1.py:31-33), clipped to uint8."""
    h, w = hw
    out = np.zeros((t_bins, h, w, 2), np.int32)
    if len(events) == 0:
        return out.astype(np.uint8)
    t = events[:, 0].astype(np.float64)
    t0, t1 = t.min(), t.max()
    span = max(t1 - t0, 1e-9)
    bi = np.minimum(((t - t0) / span * t_bins).astype(np.int64), t_bins - 1)
    x = np.clip(events[:, 1].astype(np.int64), 0, w - 1)
    y = np.clip(events[:, 2].astype(np.int64), 0, h - 1)
    p = (events[:, 3] > 0).astype(np.int64)
    np.add.at(out, (bi, y, x, p), 1)
    return np.clip(out, 0, 255).astype(np.uint8)


def convert_events_dir(src_dir: str, out_dir: str, hw: tuple[int, int],
                       t_bins: int) -> int:
    """Every .npy/.npz event array under src_dir -> voxelized frame .npy
    under out_dir (same relative paths).  The mean over T is stored as one
    [H, W, 2] frame per recording — the DDD17 T4 preprocessing layout."""
    n = 0
    for root, _, files in os.walk(src_dir):
        for f in sorted(files):
            if not f.endswith((".npy", ".npz")):
                continue
            arr = np.load(os.path.join(root, f))
            if isinstance(arr, np.lib.npyio.NpzFile):
                arr = arr[arr.files[0]]
            frames = voxelize_events(np.asarray(arr), hw, t_bins)
            rel = os.path.relpath(root, src_dir)
            od = os.path.join(out_dir, rel)
            os.makedirs(od, exist_ok=True)
            np.save(os.path.join(od, f[:f.rfind(".")] + ".npy"),
                    frames.mean(0).astype(np.uint8))
            n += 1
    return n


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
    pc = sub.add_parser("pascal_context")
    pc.add_argument("json_path")
    pc.add_argument("voc_dir")
    pc.add_argument("-o", "--out-dir", default=None)
    ev = sub.add_parser("events")
    ev.add_argument("src_dir")
    ev.add_argument("out_dir")
    ev.add_argument("--height", type=int, default=200)
    ev.add_argument("--width", type=int, default=352)
    ev.add_argument("--t-bins", type=int, default=4)
    args = ap.parse_args(argv)

    if args.cmd == "cityscapes":
        n = convert_dir(args.gtfine_dir, "_gtFine_labelIds.png",
                        "_gtFine_labelTrainIds.png", CITYSCAPES_LABEL2TRAIN)
    elif args.cmd == "coco_stuff":
        n = convert_dir(args.ann_dir, ".png", "_labelTrainIds.png",
                        _coco_lut())
    elif args.cmd == "voc_aug":
        n = convert_voc_aug(args.sbd_dir, args.voc_dir)
    elif args.cmd == "pascal_context":
        n = convert_pascal_context(args.json_path, args.voc_dir,
                                   args.out_dir)
    else:
        n = convert_events_dir(args.src_dir, args.out_dir,
                               (args.height, args.width), args.t_bins)
    print(f"converted {n} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
