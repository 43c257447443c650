from .base_dataset import KittiMono3D, load_split_ids
from .calib import Calibration
from .kitti_raw import KITTIRawDataset
from .labels import CLASS_TO_IDX, IDX_TO_CLASS, ObjectLabels
from .loader import DataLoader, collate
from .monocon_dataset import DEFAULT_FILTER_CONFIG, MonoConDataset, empty_labels
from .png import read_png, write_png

__all__ = [
    "CLASS_TO_IDX",
    "Calibration",
    "DEFAULT_FILTER_CONFIG",
    "DataLoader",
    "IDX_TO_CLASS",
    "KITTIRawDataset",
    "KittiMono3D",
    "MonoConDataset",
    "ObjectLabels",
    "collate",
    "empty_labels",
    "load_split_ids",
    "read_png",
    "write_png",
]
