"""Dataset metainfo (port of the ADE20K entry of
``spike2former_tpu/data/metainfo.py``): class names, label conventions and
the directory layout."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DatasetMeta:
    name: str
    classes: tuple
    reduce_zero_label: bool
    img_suffix: str = ".jpg"
    seg_suffix: str = ".png"
    ignore_index: int = 255
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

ADE20K = DatasetMeta(
    name="ade20k", classes=ADE20K_CLASSES, reduce_zero_label=True,
    splits={"train": ("images/training", "annotations/training"),
            "val": ("images/validation", "annotations/validation")})

DATASETS = {d.name: d for d in (ADE20K,)}
