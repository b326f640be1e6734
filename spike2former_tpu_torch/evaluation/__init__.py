from .cityscapes_metric import CityscapesEval, evaluate_cityscapes_dir
from .iou_metric import IoUState, compute_iou, init_iou, update_iou_np
from .panoptic import PQStat, compute_pq, pq_update

__all__ = ["IoUState", "init_iou", "update_iou_np", "compute_iou",
           "PQStat", "pq_update", "compute_pq", "CityscapesEval",
           "evaluate_cityscapes_dir"]
