from .kitti_eval import kitti_eval, kitti_eval_coco_style
from .protocol import eval_class, image_box_overlap

__all__ = [
    "kitti_eval",
    "kitti_eval_coco_style",
    "eval_class",
    "image_box_overlap",
]
