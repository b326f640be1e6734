from . import transforms
from .dataset import SegDataset, make_dataset
from .loader import TrainLoader, eval_batches
from .metainfo import ADE20K, CITYSCAPES, DATASETS, VOC2012, DatasetMeta
from .panoptic import (PanopticDataset, decode_pan_png, encode_pan_png,
                       panoptic_maps, panoptic_to_instances,
                       panoptic_train_batches)

__all__ = [
    "DATASETS", "DatasetMeta", "ADE20K", "CITYSCAPES", "VOC2012",
    "SegDataset", "make_dataset", "TrainLoader", "eval_batches",
    "PanopticDataset", "panoptic_maps", "panoptic_to_instances",
    "panoptic_train_batches", "decode_pan_png", "encode_pan_png",
    "transforms",
]
