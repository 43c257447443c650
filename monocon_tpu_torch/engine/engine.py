"""The port's evaluation engine: a KITTI split, a checkpoint, the AP40 dict.

Port of the evaluation half of ``monocon_tpu/engine/engine.py``
(``MonoConEngine(cfg, is_test=True)``: the test loader, the detector,
``load_checkpoint``, ``evaluate``). Training (``is_test=False``) comes with
ROADMAP item 10.

The evaluation loop keeps the card and the host working at once, as the
JAX engine's does: batch i+1's forward is queued before batch i's
detections are converted to KITTI annotations on the host.

  * The loader's thread copies each batch from a pinned canvas on a copy
    stream; the compute stream waits on that copy's event.
  * The image is normalised on the device (``normalize_if_raw``), then the
    forward and ``decode_predictions`` run.
  * Right after the decode, the decoded dict (B x 30 boxes) is copied into
    pinned host buffers with ``non_blocking=True`` and an event is
    recorded. Then the next batch is queued. Conversion waits on that event
    only, not on the next batch's forward, which a plain ``.cpu()`` would.
  * The last batch is as short as the split leaves it: no padding rows.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Union

import torch

from ..config import ConfigNode, check_port_support, get_default_cfg, load_cfg
from ..data.loader import DataLoader, use_on_current_stream
from ..data.monocon_dataset import MonoConDataset
from ..data.transforms import default_test_transforms
from ..device import resolve_device
from ..models.detector import create_detector
from ..ops.decode import decode_predictions
from ..ops.image_norm import normalize_if_raw
from ..utils.convert import (
    convert_to_kitti_2d,
    convert_to_kitti_3d,
    split_batch_detections,
)
from .checkpoint import load_weights

TEST_SCORE_THRESHOLD = 0.4  # reference DEFAULT_TEST_CFG (monocon_heads.py:30-35)
EVAL_CLASSES = ("Pedestrian", "Cyclist", "Car")


class MonoConEngine:
    def __init__(
        self,
        cfg: Union[str, ConfigNode, None] = None,
        is_test: bool = False,
        device: "str | torch.device | None" = None,
    ):
        """``device``: the card unless the caller names another (see
        :func:`resolve_device`)."""
        if not is_test:
            raise NotImplementedError(
                "the port's engine evaluates only (is_test=True); the "
                "training loop is ROADMAP item 10")
        if cfg is None:
            cfg = get_default_cfg()
        elif isinstance(cfg, str):
            cfg = load_cfg(cfg)
        check_port_support(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.test_dataset, self.test_loader = self._build_loader()
        self.model = create_detector(
            cfg.MODEL.BACKBONE.NUM_LAYERS, cfg.MODEL.HEAD.NUM_CLASSES,
            generator=torch.Generator().manual_seed(max(cfg.SEED, 0)),
            device=self.device).eval()

    def _build_loader(self):
        cfg = self.cfg
        # uint8 transport defers normalization to the device: 4x fewer
        # bytes to copy.
        dev_norm = cfg.TPU.IMAGE_TRANSPORT == "uint8"
        dataset = MonoConDataset(
            base_root=cfg.DATA.ROOT,
            split=cfg.DATA.TEST_SPLIT,
            max_objs=cfg.MODEL.HEAD.MAX_OBJS,
            transforms=default_test_transforms(device_normalize=dev_norm),
            filter_configs={k.lower(): v for k, v in cfg.DATA.FILTER.items()},
        )
        pad_hw = cfg.TPU.PAD_HW
        loader = DataLoader(
            dataset,
            self.device,
            batch_size=cfg.DATA.BATCH_SIZE,
            shuffle=False,
            num_workers=cfg.DATA.NUM_WORKERS,
            pad_hw=tuple(pad_hw) if pad_hw else None,
            seed=max(cfg.SEED, 0),
            prefetch_batches=cfg.TPU.PREFETCH_BATCHES,
        )
        return dataset, loader

    def load_checkpoint(self, path: str) -> None:
        """Load the detector's weights from a reference-format ``.pth``."""
        load_weights(path, self.model)

    def _on_device(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    # ------------------------------------------------------------------
    def evaluate(self, verbose: bool = True) -> Dict[str, float]:
        """Collect detections over the test split and run KITTI AP."""
        return self.test_dataset.evaluate(
            self.collect_detections(), eval_classes=EVAL_CLASSES,
            verbose=verbose)

    def collect_detections(self, device_ms: Optional[List[float]] = None
                           ) -> Dict[str, List[Dict[str, Any]]]:
        """KITTI annotations of every test image, 3D (``img_bbox``) and 2D
        (``img_bbox2d``). On the card, ``device_ms``, when given, receives
        each batch's device milliseconds from the normalisation to the end
        of the decode, by CUDA events."""
        container: Dict[str, List] = {"img_bbox": [], "img_bbox2d": []}
        events = ([] if device_ms is not None and self.device.type == "cuda"
                  else None)
        pending = None  # (dispatched, batch)
        with self._on_device():
            for batch in self.test_loader:
                dispatched = self._dispatch_eval(batch, events)
                if pending is not None:
                    self._collect_eval(*pending, container)
                pending = (dispatched, batch)
            if pending is not None:
                self._collect_eval(*pending, container)
        if events is not None:
            for start, end in events:
                end.synchronize()
                device_ms.append(start.elapsed_time(end))
        return container

    def _dispatch_eval(self, batch: Dict[str, Any], events=None):
        """Queue the forward and decode of a loader batch; on the card also
        the copy of the result to pinned host memory. Returns (decoded,
        the copy's event or None)."""
        dev = use_on_current_stream(batch)
        if events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.no_grad():
            image = normalize_if_raw(dev["img"], dev["img_hw"])
            pred = self.model(image)
            decoded = decode_predictions(pred, dev["p2"],
                                         (image.shape[1], image.shape[2]))
        if self.device.type != "cuda":
            return decoded, None
        if events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((start, end))
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in decoded.items()}
        for k, v in decoded.items():
            host[k].copy_(v, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    def _finalize_eval(self, dispatched, batch: Dict[str, Any]):
        """Wait for a dispatched batch's decoded arrays and convert them to
        KITTI annotations."""
        decoded, copied = dispatched
        if copied is not None:
            copied.synchronize()
        per_image = split_batch_detections(
            {k: v.numpy() for k, v in decoded.items()}, TEST_SCORE_THRESHOLD)
        return {
            "img_bbox": convert_to_kitti_3d(
                per_image, batch["img_metas"], batch["calib"]
            ),
            "img_bbox2d": convert_to_kitti_2d(per_image, batch["img_metas"]),
        }

    def _collect_eval(self, dispatched, batch, container) -> None:
        result = self._finalize_eval(dispatched, batch)
        container["img_bbox"].extend(result["img_bbox"])
        container["img_bbox2d"].extend(result["img_bbox2d"])

    def run_eval_batch(self, batch: Dict[str, Any]):
        """One loader batch through the whole path, unpipelined."""
        with self._on_device():
            return self._finalize_eval(self._dispatch_eval(batch), batch)
