"""Dataset metainfo (port of ``spike2former_tpu/data/metainfo.py``, its ten
entries): class names, palettes (mmseg's METAINFO blocks), label
conventions and the directory layouts."""
from __future__ import annotations

from dataclasses import dataclass, field

from .label_constants import (ADE20K_PALETTE, CITYSCAPES_PALETTE,
                              COCO_STUFF_CLASSES, COCO_STUFF_PALETTE,
                              PASCAL_CONTEXT59_CLASSES,
                              PASCAL_CONTEXT_CLASSES, PASCAL_CONTEXT_PALETTE,
                              SYNAPSE_CLASSES, SYNAPSE_PALETTE, VOC_PALETTE)


@dataclass(frozen=True)
class DatasetMeta:
    name: str
    classes: tuple
    reduce_zero_label: bool
    img_suffix: str = ".jpg"
    seg_suffix: str = ".png"
    ignore_index: int = 255
    # fixed visualization palette (mmseg METAINFO); None -> generated
    palette: tuple | None = None
    # relative dirs (mmseg layout): (img_dir, ann_dir) per split
    splits: dict = field(default_factory=dict)

    @property
    def num_classes(self) -> int:
        return len(self.classes)


ADE20K_CLASSES = (
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper", "fireplace",
    "refrigerator", "grandstand", "path", "stairs", "runway", "case",
    "pool table", "pillow", "screen door", "stairway", "river", "bridge",
    "bookcase", "blind", "coffee table", "toilet", "flower", "book", "hill",
    "bench", "countertop", "stove", "palm", "kitchen island", "computer",
    "swivel chair", "boat", "bar", "arcade machine", "hovel", "bus", "towel",
    "light", "truck", "tower", "chandelier", "awning", "streetlight",
    "booth", "television receiver", "airplane", "dirt track", "apparel",
    "pole", "land", "bannister", "escalator", "ottoman", "bottle", "buffet",
    "poster", "stage", "van", "ship", "fountain", "conveyer belt", "canopy",
    "washer", "plaything", "swimming pool", "stool", "barrel", "basket",
    "waterfall", "tent", "bag", "minibike", "cradle", "oven", "ball",
    "food", "step", "tank", "trade name", "microwave", "pot", "animal",
    "bicycle", "lake", "dishwasher", "screen", "blanket", "sculpture",
    "hood", "sconce", "vase", "traffic light", "tray", "ashcan", "fan",
    "pier", "crt screen", "plate", "monitor", "bulletin board", "shower",
    "radiator", "glass", "clock", "flag",
)

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
)

VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)

ADE20K = DatasetMeta(
    name="ade20k", classes=ADE20K_CLASSES, palette=ADE20K_PALETTE,
    reduce_zero_label=True,
    splits={"train": ("images/training", "annotations/training"),
            "val": ("images/validation", "annotations/validation")})

# labelTrainIds maps written by tools/dataset_converters.py cityscapes
CITYSCAPES = DatasetMeta(
    name="cityscapes", classes=CITYSCAPES_CLASSES,
    palette=CITYSCAPES_PALETTE, reduce_zero_label=False,
    img_suffix="_leftImg8bit.png", seg_suffix="_gtFine_labelTrainIds.png",
    splits={"train": ("leftImg8bit/train", "gtFine/train"),
            "val": ("leftImg8bit/val", "gtFine/val")})

# both splits list every image of JPEGImages, as the JAX entry does
VOC2012 = DatasetMeta(
    name="voc2012", classes=VOC_CLASSES, palette=VOC_PALETTE,
    reduce_zero_label=False, img_suffix=".jpg", seg_suffix=".png",
    splits={"train": ("JPEGImages", "SegmentationClass"),
            "val": ("JPEGImages", "SegmentationClass")})

# labelTrainIds maps written by tools/dataset_converters.py coco_stuff
COCO_STUFF_164K = DatasetMeta(
    name="coco_stuff164k", classes=COCO_STUFF_CLASSES,
    palette=COCO_STUFF_PALETTE, reduce_zero_label=False,
    img_suffix=".jpg", seg_suffix="_labelTrainIds.png",
    splits={"train": ("images/train2017", "annotations/train2017"),
            "val": ("images/val2017", "annotations/val2017")})

PASCAL_CONTEXT = DatasetMeta(
    name="pascal_context", classes=PASCAL_CONTEXT_CLASSES,  # background
    palette=PASCAL_CONTEXT_PALETTE, reduce_zero_label=False,  # + 59
    splits={"train": ("JPEGImages", "SegmentationClassContext"),
            "val": ("JPEGImages", "SegmentationClassContext")})

PASCAL_CONTEXT_59 = DatasetMeta(
    name="pascal_context59", classes=PASCAL_CONTEXT59_CLASSES,
    reduce_zero_label=True,  # mmseg PascalContextDataset59
    splits={"train": ("JPEGImages", "SegmentationClassContext"),
            "val": ("JPEGImages", "SegmentationClassContext")})

# Synapse multi-organ CT (mmseg synapse.py)
SYNAPSE = DatasetMeta(
    name="synapse", classes=SYNAPSE_CLASSES, palette=SYNAPSE_PALETTE,
    reduce_zero_label=False, img_suffix=".jpg", seg_suffix=".png",
    splits={"train": ("img_dir/train", "ann_dir/train"),
            "val": ("img_dir/val", "ann_dir/val")})

# retina-vessel binary segmentation sets (mmseg DRIVE, ChaseDB1): png pairs
DRIVE = DatasetMeta(
    name="drive", classes=("background", "vessel"), reduce_zero_label=False,
    img_suffix=".png", seg_suffix="_manual1.png",
    splits={"train": ("images/training", "annotations/training"),
            "val": ("images/validation", "annotations/validation")})

CHASE_DB1 = DatasetMeta(
    name="chase_db1", classes=("background", "vessel"),
    reduce_zero_label=False, img_suffix=".png", seg_suffix="_1stHO.png",
    splits={"train": ("images/training", "annotations/training"),
            "val": ("images/validation", "annotations/validation")})

# DDD17 DVS event-camera driving (mmseg ddd17.py:17-36 and
# configs/_base_/datasets/ddd17.py): 6 classes over event frames stored as
# .npy files in the ADE layout (``data/transforms.py:load_image``), eval at
# the native 200x352
DDD17 = DatasetMeta(
    name="ddd17",
    classes=("flat", "construction+sky", "object", "nature", "human",
             "vehicle"),
    palette=((120, 120, 120), (180, 120, 120), (6, 230, 230), (80, 50, 50),
             (4, 200, 3), (120, 120, 80)),
    reduce_zero_label=False, img_suffix=".npy", seg_suffix=".png",
    splits={"train": ("images/training", "annotations/training"),
            "val": ("images/validation", "annotations/validation")})

DATASETS = {d.name: d for d in (ADE20K, CITYSCAPES, VOC2012,
                                COCO_STUFF_164K, PASCAL_CONTEXT,
                                PASCAL_CONTEXT_59, SYNAPSE, DRIVE, CHASE_DB1,
                                DDD17)}
