"""Configuration tree of the port.

A copy of ``monocon_tpu/config/defaults.py``: the same key tree, ``TPU.*``
included, so that the files in ``configs/`` load in both packages. Files are
read and written by ``yaml_subset.py``, with no PyYAML (the card's machine
has none). The port runs every setting of the tree; the engine refuses
what the JAX engine refuses (``engine/engine.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from . import yaml_subset


class ConfigNode(dict):
    """A dict with attribute access and recursive merge, yacs-compatible
    enough for this project's config files."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def merge_from_dict(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_dict(v)
            elif isinstance(v, dict):
                self[k] = _to_node(v)
            else:
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        with open(path, encoding="utf-8") as f:
            data = yaml_subset.safe_load(f.read())
        if data:
            self.merge_from_dict(data)

    def to_plain_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_plain_dict() if isinstance(v, ConfigNode) else v
        return out

    def dump(self) -> str:
        """The tree as block-style YAML (:func:`yaml_subset.dump`)."""
        return yaml_subset.dump(self)


def _to_node(d: Dict[str, Any]) -> ConfigNode:
    node = ConfigNode()
    for k, v in d.items():
        node[k] = _to_node(v) if isinstance(v, dict) else v
    return node


_DEFAULTS: Dict[str, Any] = {
    "VERSION": "tpu-v0.1.0",
    "DESCRIPTION": "MonoCon-TPU Default Configuration",
    "OUTPUT_DIR": "",
    "SEED": -1,
    "GPU_ID": 0,  # the test CLI's --gpu_id picks the card instead
    "USE_BENCHMARK": True,  # the train CLI's cudnn.benchmark
    "DATA": {
        "ROOT": "/data/kitti",
        "BATCH_SIZE": 8,
        "NUM_WORKERS": 4,  # loader threads decoding PNGs
        "TRAIN_SPLIT": "train",
        "TEST_SPLIT": "val",
        "CROP_HW": [320, 960],  # train-time RandomCrop3D size
        "AUGMENT": True,  # train-time augmentation on or off
        # Decoded-uint8 image cache: '' off, 'auto' beside the data, or a
        # directory (data/image_cache.py).
        "IMAGE_CACHE": "",
        "FILTER": {
            "MIN_HEIGHT": 25,
            "MIN_DEPTH": 2,
            "MAX_DEPTH": 65,
            "MAX_TRUNCATION": 0.5,
            "MAX_OCCLUSION": 2,
        },
    },
    "MODEL": {
        "BACKBONE": {
            "NUM_LAYERS": 34,
            "IMAGENET_PRETRAINED": True,
            # Local path to a DLA ImageNet .pth (training only).
            "PRETRAINED_PATH": "",
        },
        "HEAD": {
            "NUM_CLASSES": 3,
            "MAX_OBJS": 30,
        },
    },
    "SOLVER": {
        "OPTIM": {
            "LR": 2.25e-4,
            "WEIGHT_DECAY": 1e-5,
            "NUM_EPOCHS": 200,
        },
        "SCHEDULER": {
            "ENABLE": True,
        },
        "CLIP_GRAD": {
            "ENABLE": True,
            "NORM_TYPE": 2.0,
            "MAX_NORM": 35,
        },
    },
    "PERIOD": {
        "EVAL_PERIOD": 10,
        "LOG_PERIOD": 50,
        "CKPT_PERIOD_STEPS": 0,  # mid-epoch checkpoints, in steps (0 = off)
    },
    # The JAX package's accelerator knobs, under the same name so that one
    # config file serves both packages. The port reads all but
    # PALLAS_TARGETS.
    "TPU": {
        "COMPUTE_DTYPE": "float32",
        # Processes, one per GPU (-1: every visible GPU; on the CPU, one),
        # clamped to divide DATA.BATCH_SIZE (parallel/distributed.py).
        "NUM_DEVICES": -1,
        "GRAD_ACCUM_STEPS": 1,
        # Bands of the canvas height, one a rank: NUM_DEVICES processes
        # form (NUM_DEVICES // SPATIAL_SHARDS) data shards x SPATIAL_SHARDS
        # (parallel/mesh.py); needs a static PAD_HW.
        "SPATIAL_SHARDS": 1,
        "MULTIHOST": False,
        "PREFETCH_BATCHES": 2,        # batches the loader prepares ahead
        "PALLAS_TARGETS": "auto",     # the JAX package's switch only
        "PAD_HW": [384, 1248],        # static batch canvas (null: per-batch)
        # 'uint8': ship raw pixels, normalise on the device (4x fewer
        # bytes to copy, exact for evaluation). 'float32': normalise on
        # the host.
        "IMAGE_TRANSPORT": "uint8",
    },
}


def get_default_cfg() -> ConfigNode:
    """Reference parity: ``utils/engine_utils.py:38-40``."""
    return _to_node(_DEFAULTS)


def load_cfg(cfg_file: str) -> ConfigNode:
    """Reference parity: ``utils/engine_utils.py:42-46`` (merge YAML over
    defaults, new keys allowed)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(cfg_file)
    return cfg


def export_cfg(cfg: ConfigNode, save_path: str) -> None:
    """Reference parity: ``utils/engine_utils.py:49-52``."""
    with open(save_path, "w") as f:
        f.write(cfg.dump())

