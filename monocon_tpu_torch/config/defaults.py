"""Configuration tree of the port.

A copy of ``monocon_tpu/config/defaults.py``: the same key tree, ``TPU.*``
included, so that the files in ``configs/`` load in both packages. PyYAML
is imported only where a file is read, so that :func:`get_default_cfg` and
:func:`export_cfg` work without it (the card's machine has none):
:meth:`ConfigNode.dump` writes YAML itself. :func:`check_port_support`
refuses the settings the port does not run yet.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Dict, List


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
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        if data:
            self.merge_from_dict(data)

    def to_plain_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_plain_dict() if isinstance(v, ConfigNode) else v
        return out

    def dump(self) -> str:
        """The tree as block-style YAML that ``yaml.safe_load`` reads back
        equal: nested mappings, and lists and scalars of str, int, float,
        bool and None."""
        return "".join(line + "\n" for line in _yaml_lines(self, 0))


# Plain YAML 1.1 scalars that would not read back as the same string.
_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")
_YAML_WORDS = {"y", "n", "yes", "no", "on", "off", "true", "false", "null"}


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # YAML 1.1 reads a float only with a dot in its mantissa.
        mantissa, e, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(value, str):
        return json.dumps(value)     # a valid YAML double-quoted scalar
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(v) for v in value) + "]"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _yaml_key(key: str) -> str:
    key = str(key)
    if _PLAIN_KEY.match(key) and key.lower() not in _YAML_WORDS:
        return key
    return json.dumps(key)


def _yaml_lines(tree: Dict[str, Any], depth: int) -> List[str]:
    pad = "  " * depth
    lines = []
    for key, value in tree.items():
        if isinstance(value, dict) and value:
            lines.append(f"{pad}{_yaml_key(key)}:")
            lines.extend(_yaml_lines(value, depth + 1))
        else:
            text = "{}" if isinstance(value, dict) else _yaml_scalar(value)
            lines.append(f"{pad}{_yaml_key(key)}: {text}")
    return lines


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
    # config file serves both packages. The port reads PAD_HW,
    # IMAGE_TRANSPORT and PREFETCH_BATCHES, and refuses what it does not
    # run yet (check_port_support).
    "TPU": {
        "COMPUTE_DTYPE": "float32",
        "NUM_DEVICES": -1,            # -1: all devices (the port: one)
        "GRAD_ACCUM_STEPS": 1,
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


# The solver the port trains with: AdamW's weight decay, the one-cycle
# schedules and the global-norm clip at 35 are fixed (solver/schedule.py,
# engine/train_step.py).
_FIXED_SOLVER = {"OPTIM.WEIGHT_DECAY": 1e-5, "SCHEDULER.ENABLE": True,
                 "CLIP_GRAD.ENABLE": True, "CLIP_GRAD.MAX_NORM": 35}


def check_port_support(cfg: ConfigNode, training: bool = False) -> None:
    """Raise ``NotImplementedError`` for settings the port does not run yet,
    naming the ROADMAP item that will bring each. ``training``: also the
    settings that only training reads."""
    if cfg.TPU.COMPUTE_DTYPE != "float32":
        raise NotImplementedError(
            f"TPU.COMPUTE_DTYPE={cfg.TPU.COMPUTE_DTYPE!r}: the port computes "
            "in float32 only; bfloat16 is ROADMAP item 14")
    if training and cfg.TPU.GRAD_ACCUM_STEPS > 1:
        raise NotImplementedError(
            f"TPU.GRAD_ACCUM_STEPS={cfg.TPU.GRAD_ACCUM_STEPS}: the port takes "
            "one optimizer step per batch; gradient accumulation is ROADMAP "
            "item 13")
    if training:
        for name, want in _FIXED_SOLVER.items():
            group, key = name.split(".")
            if cfg.SOLVER[group][key] != want:
                raise NotImplementedError(
                    f"SOLVER.{name}={cfg.SOLVER[group][key]!r}: the port "
                    f"trains with {want!r} only (ROADMAP item 10, left)")
    if (cfg.TPU.NUM_DEVICES > 1 or cfg.TPU.SPATIAL_SHARDS > 1
            or cfg.TPU.MULTIHOST):
        raise NotImplementedError(
            f"TPU.NUM_DEVICES={cfg.TPU.NUM_DEVICES}, TPU.SPATIAL_SHARDS="
            f"{cfg.TPU.SPATIAL_SHARDS}, TPU.MULTIHOST={cfg.TPU.MULTIHOST}: "
            "the port runs on one device; multi-GPU is ROADMAP item 16")
