"""MonoCon training and evaluation engine of the port.

Port of ``monocon_tpu/engine/engine.py`` (reference
``engine/base_engine.py`` + ``engine/monocon_engine.py``): 1-based epoch
counters, auto-resume from the latest complete checkpoint (mid-epoch ones
included, with the interrupted run's data seed), an evaluation every
EVAL_PERIOD epochs followed by a checkpoint, a checkpoint every
CKPT_PERIOD_STEPS steps, console logging every LOG_PERIOD steps with
progress bar, LR and 100-step mean, ``loss/*`` and ``eval/*`` scalars in
``tf_logs/metrics.jsonl`` (and ``time/*`` per epoch: its seconds, steps,
ms/step and images/s), and the config exported at the start of
training.

Training runs ``train_step`` (targets with the CUDA splat kernel on the
card, forward, 10 losses, backward, the solver: accumulation, clip, AdamW)
on each loader batch as it comes: the last batch of an epoch is as short
as the split leaves it, where the JAX engine pads it and masks the padding
out. With ``TPU.GRAD_ACCUM_STEPS = k > 1`` each loader batch is one
micro-step and AdamW steps on every k-th, on the mean gradient, as
``optax.MultiSteps`` does in the JAX engine: a short last batch counts as
one micro-step of equal weight, and an accumulation left open at the end
of an epoch carries into the next. The schedules run over loader steps
// k optimizer steps; ``global_iters``, logging and ``CKPT_PERIOD_STEPS``
count loader batches. ``TPU.COMPUTE_DTYPE = bfloat16`` runs the
detector's forward in bfloat16 (``models/detector.py``) for training and
evaluation alike; parameters, optimizer state and targets stay float32.
The loss of each step stays on the device; the host reads them in one
stacked copy on log steps and at the end of the epoch, never one per
step.

``train(resume_from=...)`` resumes the run of a checkpoint directory (or
its ``state.pth``) named by the caller, after the config is exported, in
place of whatever auto-resume found under ``OUTPUT_DIR``.

The evaluation loop keeps the card and the host working at once, as the
JAX engine's does: batch i+1's forward is queued before batch i's
detections are converted to KITTI annotations on the host
(:func:`dispatch_detection` and :func:`fetch_detection`, which the raw
stream of ``test_raw.py`` shares).

  * The loader's thread copies each batch from a pinned canvas on a copy
    stream; the compute stream waits on that copy's event.
  * The image is normalised on the device (``normalize_if_raw``), then the
    forward and ``decode_predictions`` run.
  * Right after the decode, the decoded dict (B x 30 boxes) is copied into
    pinned host buffers with ``non_blocking=True`` and an event is
    recorded. Then the next batch is queued. Conversion waits on that event
    only, not on the next batch's forward, which a plain ``.cpu()`` would.
  * The last batch is as short as the split leaves it: no padding rows.

``visualize`` draws every test image's detections in the visualization
format (2D boxes, 3D wireframes, bird's-eye view) into PNG files.

Data parallelism. In a process group of more than one rank (the CLIs join
one from torchrun's environment or spawn one process per device,
``parallel/distributed.py``), ``DATA.BATCH_SIZE`` is the global batch and
each rank loads, trains on and evaluates its rows of it, the remainder
batch padded and masked (``data/loader.py``), as the JAX engine shards a
batch over its mesh. Training runs a ``DistributedDataParallel`` wrapper
(``train_model``) with BN moments and loss normalisers of the global batch
(``train_step``), so a step equals one process's step on the whole batch.
Every rank starts from rank 0's weights and resumes from the checkpoint
that rank 0 finds. Evaluation gathers the ranks' KITTI annotations on rank
0, which computes the AP dict and hands it to every rank. Rank 0 alone
prints, writes ``config.yaml``, the checkpoints and the metrics file,
and draws (``visualize``). Eval-mode forwards use the unwrapped
``model``.

The image height split over ranks. ``TPU.SPATIAL_SHARDS = S > 1`` needs a
static ``TPU.PAD_HW`` whose height ``S`` divides within the JAX package's
envelope (``parallel/mesh.py``); the engine checks both before it touches
data, as the JAX engine does, and needs a process group of ``D x S``
ranks. Rank ``r`` loads the rows of data shard ``r // S`` and uploads band
``r % S`` of their canvas; training wraps the model over every rank,
takes BN moments over every rank and loss sums over the data shards, and
the heads' maps are gathered whole on every rank of a band group
(``engine/train_step.py``). Evaluation runs the same banded forward, and
the detections of each data shard come from its first band's rank.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import ConfigNode, export_cfg, get_default_cfg, load_cfg
from ..data.loader import DataLoader, use_on_current_stream
from ..data.monocon_dataset import MonoConDataset
from ..data.transforms import default_test_transforms, default_train_transforms
from ..device import resolve_device
from ..models.detector import conv_memory_format, create_detector
from ..ops.decode import decode_predictions
from ..ops.image_norm import normalize_if_raw
from ..parallel import data_parallel, rank_and_world, replicate_state
from ..parallel.mesh import (SpatialLayout, spatial_layout,
                             validate_spatial_shards)
from ..parallel.spatial import spatial_scope
from ..solver.schedule import build_optimizer
from ..utils.convert import (
    convert_to_kitti_2d,
    convert_to_kitti_3d,
    split_batch_detections,
    to_vis_format,
)
from ..utils.logging_utils import (MetricsWriter, count_params, progress_bar,
                                   tprint)
from .checkpoint import (
    STATE_FILE,
    latest_checkpoint,
    load_checkpoint,
    load_imagenet_backbone,
    load_weights,
    save_checkpoint,
)
from .train_step import train_step

TEST_SCORE_THRESHOLD = 0.4  # reference DEFAULT_TEST_CFG (monocon_heads.py:30-35)
EVAL_CLASSES = ("Pedestrian", "Cyclist", "Car")


def dispatch_detection(model, image: torch.Tensor, img_hw: torch.Tensor,
                       p2: torch.Tensor, events: Optional[list] = None,
                       layout: Optional[SpatialLayout] = None):
    """Queue the normalisation, forward and decode of a (B, H, W, 3) batch
    already on the model's device, and on the card also the copy of the
    decoded arrays into pinned host memory. Returns (decoded, the copy's
    event or None) without waiting for the card. ``events``, on the card,
    receives the (start, end) CUDA events around the device work. With a
    ``layout`` of several bands, ``image`` is this rank's band of the
    canvas, and every rank of its space group decodes the whole maps."""
    cuda = image.device.type == "cuda"
    if events is not None and cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    row0, pad_h = 0, image.shape[1]
    if layout is not None and layout.spatial > 1:
        row0, pad_h = layout.band[0], layout.pad_h
    with torch.no_grad(), spatial_scope(model, layout):
        image = normalize_if_raw(image, img_hw, row0)
        decoded = decode_predictions(model(image), p2,
                                     (pad_h, image.shape[2]))
    if not cuda:
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


def fetch_detection(dispatched) -> Dict[str, np.ndarray]:
    """Wait for a :func:`dispatch_detection` result's copy; its arrays."""
    decoded, copied = dispatched
    if copied is not None:
        copied.synchronize()
    return {k: v.numpy() for k, v in decoded.items()}


class MonoConEngine:
    def __init__(
        self,
        cfg: Union[str, ConfigNode, None] = None,
        auto_resume: bool = True,
        is_test: bool = False,
        device: "str | torch.device | None" = None,
        autotune: Optional[bool] = None,
    ):
        """``device``: the card unless the caller names another (see
        :func:`resolve_device`). ``autotune``: whether cuDNN autotunes this
        process's convolutions, as the process's owner set
        ``torch.backends.cudnn.benchmark`` (``train.configure_backends``);
        by default ``cfg.USE_BENCHMARK``. With the device and the compute
        dtype it picks the model's memory format (``conv_memory_format``)."""
        if cfg is None:
            cfg = get_default_cfg()
        elif isinstance(cfg, str):
            cfg = load_cfg(cfg)
        self.cfg = cfg
        self.is_test = is_test
        spatial = max(1, int(cfg.TPU.SPATIAL_SHARDS))
        if spatial > 1:
            # As the JAX engine (engine.py:96-109): a static canvas whose
            # height the bands split within the envelope.
            if not cfg.TPU.PAD_HW:
                raise ValueError(
                    "TPU.SPATIAL_SHARDS > 1 requires a static TPU.PAD_HW "
                    "canvas (spatial sharding splits the canvas height)")
            validate_spatial_shards(int(cfg.TPU.PAD_HW[0]), spatial)
        self.device = resolve_device(device)
        # The process group's shape: this rank of `world`; with bands,
        # data shard `data_rank` of `data_world`.
        self.rank, self.world = rank_and_world()
        self.is_main = self.rank == 0
        self.layout: Optional[SpatialLayout] = None
        self.data_rank, self.data_world = self.rank, self.world
        if spatial > 1:
            if self.world % spatial:
                raise ValueError(
                    f"TPU.SPATIAL_SHARDS={spatial} needs a process group of "
                    f"a multiple of {spatial} ranks, not {self.world}: set "
                    "TPU.NUM_DEVICES, or launch with torchrun")
            self.layout = spatial_layout(int(cfg.TPU.PAD_HW[0]), spatial)
            self.data_rank = self.layout.data_index
            self.data_world = self.layout.data_shards

        # Counters (1-based, reference base_engine.py:35-42).
        self.epochs = 1
        self.global_iters = 1
        # Steps of the current epoch already trained before a mid-epoch
        # (CKPT_PERIOD_STEPS) resume; consumed by train_one_epoch.
        self._resume_step_in_epoch = 0
        self.target_epochs = cfg.SOLVER.OPTIM.NUM_EPOCHS
        self.log_period = cfg.PERIOD.LOG_PERIOD
        self.val_period = cfg.PERIOD.EVAL_PERIOD
        self.ckpt_period_steps = cfg.PERIOD.CKPT_PERIOD_STEPS
        # Per-step total loss: host floats, and the detached device scalars
        # of steps the host has not read yet (_materialize_losses).
        self.entire_losses: List[Any] = []
        self.epoch_times: List[float] = []
        # Steps and images the last train_one_epoch trained.
        self.epoch_steps = self.epoch_images = 0

        self.train_dataset = self.train_loader = None
        if not is_test:
            self.train_dataset, self.train_loader = self._build_loader(True)
        self.test_dataset, self.test_loader = self._build_loader(False)
        dtype = (torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                 else torch.float32)
        if autotune is None:
            autotune = bool(cfg.USE_BENCHMARK)
        self.model = create_detector(
            cfg.MODEL.BACKBONE.NUM_LAYERS, cfg.MODEL.HEAD.NUM_CLASSES,
            generator=torch.Generator().manual_seed(max(cfg.SEED, 0)),
            device=self.device, compute_dtype=dtype,
            memory_format=conv_memory_format(self.device, dtype,
                                             autotune)).eval()

        self.optimizer = self.solver = None
        if not is_test:
            pretrained = cfg.MODEL.BACKBONE.PRETRAINED_PATH
            if cfg.MODEL.BACKBONE.IMAGENET_PRETRAINED and pretrained:
                load_imagenet_backbone(pretrained, self.model)
                self._say(f"ImageNet backbone loaded from '{pretrained}'.")
            grad_accum = max(1, int(cfg.TPU.GRAD_ACCUM_STEPS))
            settings = cfg.SOLVER
            self.optimizer, self.solver = build_optimizer(
                self.model.parameters(), lr=settings.OPTIM.LR,
                weight_decay=settings.OPTIM.WEIGHT_DECAY,
                total_steps=max(1, len(self.train_loader)
                                * self.target_epochs // grad_accum),
                use_scheduler=settings.SCHEDULER.ENABLE,
                clip_grad_norm=(settings.CLIP_GRAD.MAX_NORM
                                if settings.CLIP_GRAD.ENABLE else None),
                grad_accum=grad_accum)

        # Output dirs + auto-resume (reference base_engine.py:57-78).
        self.root = cfg.OUTPUT_DIR or "./outputs"
        self.writer_dir = os.path.join(self.root, "tf_logs")
        self.weight_dir = os.path.join(self.root, "checkpoints")
        self.writer: Optional[MetricsWriter] = None
        if not is_test:
            resumed = (self._on_main(lambda: latest_checkpoint(
                self.weight_dir)) if auto_resume else None)
            if resumed:
                self.load_checkpoint(resumed)
                self._say(f"Existing checkpoint '{resumed}' is found and "
                          "loaded automatically.")
            self._on_main(lambda: [os.makedirs(d, exist_ok=True) for d in
                                   (self.writer_dir, self.weight_dir)])
        # The model that trains: over several ranks, the DDP wrapper.
        self.train_model = self.model
        if self.world > 1:
            if is_test:
                replicate_state(self.model)
            else:
                self.train_model = data_parallel(self.model, self.device)

    def _say(self, message: str) -> None:
        """``tprint`` on rank 0."""
        if self.is_main:
            tprint(message)

    def _on_main(self, fn):
        """``fn()`` on rank 0 alone, after the other ranks have come this
        far; every rank returns its result once rank 0 has it."""
        if self.world == 1:
            return fn()
        dist.barrier()
        out = [fn() if self.is_main else None]
        dist.broadcast_object_list(out, src=0)
        return out[0]

    def _build_loader(self, is_train: bool):
        cfg = self.cfg
        split = cfg.DATA.TRAIN_SPLIT if is_train else cfg.DATA.TEST_SPLIT
        # uint8 transport defers normalization to the device: 4x fewer
        # bytes to copy.
        dev_norm = cfg.TPU.IMAGE_TRANSPORT == "uint8"
        if is_train and split == "train" and cfg.DATA.AUGMENT:
            transforms = default_train_transforms(tuple(cfg.DATA.CROP_HW),
                                                  device_normalize=dev_norm)
        else:   # evaluation, or DATA.AUGMENT false: normalize/pad only
            transforms = default_test_transforms(device_normalize=dev_norm)
        dataset = MonoConDataset(
            base_root=cfg.DATA.ROOT,
            split=split,
            max_objs=cfg.MODEL.HEAD.MAX_OBJS,
            transforms=transforms,
            filter_configs={k.lower(): v for k, v in cfg.DATA.FILTER.items()},
            image_cache=cfg.DATA.IMAGE_CACHE,
        )
        pad_hw = cfg.TPU.PAD_HW
        loader = DataLoader(
            dataset,
            self.device,
            batch_size=cfg.DATA.BATCH_SIZE,
            shuffle=is_train,
            num_workers=cfg.DATA.NUM_WORKERS,
            pad_hw=tuple(pad_hw) if pad_hw else None,
            seed=max(cfg.SEED, 0),
            prefetch_batches=cfg.TPU.PREFETCH_BATCHES,
            labels=is_train,
            rank=self.data_rank,
            world=self.data_world,
            band=None if self.layout is None else self.layout.band,
        )
        return dataset, loader

    def load_checkpoint(self, path: str) -> None:
        """A checkpoint directory of a training engine resumes the run:
        weights, optimizer, solver (schedule count, an open accumulation),
        counters, loss history and the data seed. A ``.pth``/``.pt``, or
        any checkpoint in an evaluation engine, loads the detector's
        weights only."""
        if self.is_test or path.endswith((".pth", ".pt")):
            if os.path.isfile(os.path.join(path, STATE_FILE)):
                path = os.path.join(path, STATE_FILE)
            load_weights(path, self.model)
            return
        meta = load_checkpoint(path, self.model, self.optimizer,
                               self.solver)
        # Adopt the interrupted run's data seed: the loaders were built
        # with this process's cfg.SEED, but the shuffle/augmentation
        # stream belongs to the run being resumed (train.py randomizes
        # SEED=-1 per process).
        saved_seed = meta.get("seed")
        if saved_seed is not None and int(saved_seed) != max(
                int(self.cfg.SEED), 0):
            self._say(f"Resuming with the checkpoint's data seed {saved_seed}"
                      f" (this process started with SEED={self.cfg.SEED}; "
                      "the shuffle/augmentation stream follows the original "
                      "run).")
            self.cfg.SEED = int(saved_seed)
            for loader in (self.train_loader, self.test_loader):
                if loader is not None:
                    loader.seed = int(saved_seed)
        step_in_epoch = int(meta.get("step_in_epoch", 0))
        # Taken mid-epoch: re-enter the SAME epoch and skip its trained
        # prefix (the loader's per-epoch order is deterministic). Taken at
        # an epoch's end: start the next, with no skip left from an earlier
        # load (auto-resume, then train(resume_from=...)).
        self._resume_step_in_epoch = step_in_epoch
        self.epochs = int(meta["epoch"]) + (0 if step_in_epoch > 0 else 1)
        self.global_iters = int(meta["global_iters"])
        # Loss/time history (reference base_engine.py:191-219), so that the
        # moving average and the ETA continue across a resume.
        self.entire_losses = [float(v) for v in meta.get("entire_losses", [])]
        self.epoch_times = [float(v) for v in meta.get("epoch_times", [])]

    def save_checkpoint(self, final: bool = False,
                        step_in_epoch: int = 0) -> str:
        """Write the run's checkpoint for the current epoch. A mid-epoch
        save records ``step_in_epoch``, the steps of this epoch done, and
        the ``global_iters`` of the step after them."""
        self._materialize_losses()
        path = self._on_main(lambda: save_checkpoint(
            self.weight_dir, self.model, self.optimizer, self.solver,
            self.epochs, self.global_iters + (1 if step_in_epoch else 0),
            final=final,
            extra={"entire_losses": self.entire_losses,
                   "epoch_times": list(self.epoch_times),
                   "step_in_epoch": int(step_in_epoch),
                   # The run's data seed, from which the loader's order
                   # and augmentation derive: a resuming process adopts it.
                   "seed": max(int(self.cfg.SEED), 0)},
        ))
        self._say(f"Checkpoint saved to '{path}'.")
        return path

    # ------------------------------------------------------------------
    @property
    def current_lr(self) -> float:
        """The LR that the JAX engine reads from optax's injected
        hyperparams (engine.py:270-284): that of the last optimizer step,
        or before the first step the first step's."""
        if self.solver is None:
            return float(self.cfg.SOLVER.OPTIM.LR)
        return self.solver.current_lr

    def _materialize_losses(self) -> None:
        """Turn the device scalars in ``entire_losses`` into host floats
        with one stacked copy."""
        pending = [i for i, v in enumerate(self.entire_losses)
                   if not isinstance(v, float)]
        if not pending:
            return
        values = torch.stack([self.entire_losses[i] for i in pending]).cpu()
        for i, v in zip(pending, values.tolist()):
            self.entire_losses[i] = v

    def train_one_epoch(self) -> float:
        """Train the current epoch (its rest, after a mid-epoch resume);
        return its mean loss."""
        self.train_loader.set_epoch(self.epochs)
        self.epoch_steps = self.epoch_images = 0
        steps = len(self.train_loader)
        skip_steps = self._resume_step_in_epoch
        self._resume_step_in_epoch = 0
        # The restored history holds the resumed epoch's prefix: the mean
        # covers the whole epoch, as in an uninterrupted run.
        epoch_start = max(len(self.entire_losses) - skip_steps, 0)
        if skip_steps >= steps:
            # The checkpoint landed on the epoch's last step: nothing is
            # left to train, and no batch needs loading.
            epoch_losses = self.entire_losses[epoch_start:]
            return (float(np.mean(epoch_losses)) if epoch_losses
                    else float("nan"))
        with self._on_device():
            for batch_idx, batch in enumerate(self.train_loader):
                if batch_idx < skip_steps:
                    continue
                losses = train_step(self.train_model, self.optimizer,
                                    self.solver, use_on_current_stream(batch),
                                    self.layout)
                self.entire_losses.append(losses["total_loss"])
                self.epoch_steps += 1
                self.epoch_images += batch.get("num_valid",
                                               len(batch["calib"]))
                if self.global_iters % self.log_period == 0:
                    self._log_step(losses, batch_idx + 1, steps)
                if (self.ckpt_period_steps > 0
                        and self.global_iters % self.ckpt_period_steps == 0):
                    self.save_checkpoint(step_in_epoch=batch_idx + 1)
                self.global_iters += 1
        self._materialize_losses()
        epoch_losses = self.entire_losses[epoch_start:]
        return float(np.mean(epoch_losses)) if epoch_losses else float("nan")

    def _log_step(self, losses: Dict[str, torch.Tensor], done: int,
                  steps: int) -> None:
        """The progress line, and the step's losses to the metrics file:
        two stacked copies to the host (the losses, the pending history)."""
        names = sorted(losses)
        values = torch.stack([losses[k] for k in names]).cpu().tolist()
        loss_host = dict(zip(names, values))
        total = loss_host.pop("total_loss")
        self._materialize_losses()
        if not self.is_main:
            return
        recent = self.entire_losses[-100:]
        print(f"| Progress {progress_bar(done, steps)} | LR "
              f"{self.current_lr:.6f} | Loss {total:8.4f} "
              f"({sum(recent) / len(recent):8.4f}) |", flush=True)
        if self.writer is not None:
            self.writer.add_scalars(loss_host, tag="loss",
                                    step=self.global_iters)

    def _print_engine_info(self) -> None:
        """Engine banner (reference base_engine.py:253-269)."""
        if not self.is_main:
            return
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "CPU")
        if self.world > 1:
            kind += f", rank 0 of {self.world}"
        if self.layout is not None:
            kind += (f" ({self.layout.data_shards} data x "
                     f"{self.layout.spatial} space)")
        print("=" * 70)
        print(f" MonoCon Engine (PyTorch port) | {self.cfg.VERSION}")
        print(f" - Description : {self.cfg.DESCRIPTION}")
        print(f" - Device      : {self.device} ({kind})")
        print(f" - Model       : DLA-{self.cfg.MODEL.BACKBONE.NUM_LAYERS}, "
              f"{count_params(self.model) / 1e6:.2f}M params")
        if self.train_dataset is not None:
            print(f" - Train Data  : {len(self.train_dataset)} samples "
                  f"({self.cfg.DATA.TRAIN_SPLIT})")
        print(f" - Test Data   : {len(self.test_dataset)} samples "
              f"({self.cfg.DATA.TEST_SPLIT})")
        print(f" - Batch/Seed  : {self.cfg.DATA.BATCH_SIZE} / {self.cfg.SEED}")
        print("=" * 70)

    def train(self, resume_from: Optional[str] = None) -> None:
        """Train from the current epoch to NUM_EPOCHS, evaluating and saving
        a checkpoint every EVAL_PERIOD epochs, and the final checkpoint.
        ``resume_from``, a checkpoint directory or its ``state.pth``, is
        loaded after the config is exported, as the JAX engine does; the
        run then continues its epoch and step counters."""
        if self.epochs > self.target_epochs:
            raise ValueError(
                f"the run is at epoch {self.epochs}, past SOLVER.OPTIM."
                f"NUM_EPOCHS={self.target_epochs}: nothing to train")
        self._print_engine_info()
        self._on_main(lambda: export_cfg(
            self.cfg, os.path.join(self.root, "config.yaml")))
        if resume_from is not None:
            path = resume_from
            if os.path.basename(path) == STATE_FILE:
                path = os.path.dirname(path) or "."
            self.load_checkpoint(path)
            self._say(f"Training resumes from '{resume_from}'. "
                      f"(Start Epoch: {self.epochs})")
        self._say(f"Training proceeds from epoch {self.epochs} to "
                  f"epoch {self.target_epochs}.")
        self._say(f"Result files are saved to '{self.root}'.")
        if self.is_main:
            self.writer = MetricsWriter(self.writer_dir)
        try:
            for _ in range(self.epochs, self.target_epochs + 1):
                if self.is_main:
                    print(f" Epoch {self.epochs:3d} / "
                          f"{self.target_epochs:3d} ".center(90, "="))
                t0 = time.time()
                avg_loss = self.train_one_epoch()
                elapsed = time.time() - t0
                self.epoch_times.append(elapsed)
                remaining = (self.target_epochs - self.epochs) * float(
                    np.mean(self.epoch_times))
                if self.is_main:
                    print(f"\n- Average Loss: {avg_loss:.3f}")
                    print(f"- Epoch Time: {elapsed:.1f}s | ETA "
                          f"{remaining / 3600:.2f}h")
                if self.writer is not None and self.epoch_steps:
                    self.writer.add_scalars({
                        "epoch_s": elapsed, "steps": self.epoch_steps,
                        "ms_per_step": 1e3 * elapsed / self.epoch_steps,
                        "images_per_s": self.epoch_images / elapsed},
                        tag="time", step=self.epochs)
                if self.val_period > 0 and self.epochs % self.val_period == 0:
                    ap = self.evaluate()
                    if self.writer is not None:
                        self.writer.add_scalars(ap, tag="eval",
                                                step=self.epochs)
                    self.save_checkpoint()
                self.epochs += 1
            self.epochs = self.target_epochs
            self.save_checkpoint(final=True)
        finally:
            if self.writer is not None:
                self.writer.close()
                self.writer = None

    def _on_device(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    # ------------------------------------------------------------------
    def evaluate(self, verbose: bool = True) -> Dict[str, float]:
        """Collect detections over the test split and run KITTI AP (over
        several ranks: on rank 0, with every rank's detections; the dict
        is returned on every rank)."""
        container = self.collect_detections()
        return self._on_main(lambda: self.test_dataset.evaluate(
            container, eval_classes=EVAL_CLASSES, verbose=verbose))

    def collect_detections(self, device_ms: Optional[List[float]] = None
                           ) -> Dict[str, List[Dict[str, Any]]]:
        """KITTI annotations of every test image, 3D (``img_bbox``) and 2D
        (``img_bbox2d``). On the card, ``device_ms``, when given, receives
        each batch's device milliseconds from the normalisation to the end
        of the decode, by CUDA events. Over several ranks each rank
        converts its rows; rank 0 returns them all, in the split's order,
        the other ranks an empty container."""
        self.model.eval()
        # One container per batch: over several ranks rank 0 interleaves
        # the ranks' rows batch by batch.
        per_batch: List[Dict[str, List]] = []
        events = ([] if device_ms is not None and self.device.type == "cuda"
                  else None)
        pending = None  # (dispatched, batch)
        with self._on_device():
            for batch in self.test_loader:
                dispatched = self._dispatch_eval(batch, events)
                if pending is not None:
                    per_batch.append(self._collect_eval(*pending))
                pending = (dispatched, batch)
            if pending is not None:
                per_batch.append(self._collect_eval(*pending))
        if events is not None:
            for start, end in events:
                end.synchronize()
                device_ms.append(start.elapsed_time(end))
        per_batch = self._gather_batches(per_batch)
        return {key: [anno for part in per_batch for anno in part[key]]
                for key in ("img_bbox", "img_bbox2d")}

    def _gather_batches(self, per_batch: List[Any]) -> List[Any]:
        """Each data shard's per-batch results (lists, or dicts of lists,
        of its valid rows), interleaved on rank 0 batch by batch and shard
        by shard: the split's order. With bands, the first band's rank of
        each shard gives them, so that none counts twice. Other ranks get
        an empty list."""
        if self.world == 1:
            return per_batch
        first_band = self.layout is None or self.layout.space_index == 0
        gathered = [None] * self.world if self.is_main else None
        dist.gather_object(per_batch if first_band else None, gathered,
                           dst=0)
        if not self.is_main:
            return []
        shards = [g for g in gathered if g is not None]
        return [part for parts in zip(*shards) for part in parts]

    def _valid_rows(self, rows: List[Any], batch: Dict[str, Any]) -> List[Any]:
        """This data shard's ``rows`` of a loader batch without its
        padding."""
        if "num_valid" not in batch:
            return rows
        keep = batch["num_valid"] - self.data_rank * len(rows)
        return rows[:min(max(keep, 0), len(rows))]

    def _dispatch_eval(self, batch: Dict[str, Any], events=None):
        """Queue the forward and decode of a loader batch; on the card also
        the copy of the result to pinned host memory."""
        dev = use_on_current_stream(batch)
        return dispatch_detection(self.model, dev["img"], dev["img_hw"],
                                  dev["p2"], events, self.layout)

    def _finalize_eval(self, dispatched, batch: Dict[str, Any],
                       vis_format: bool = False):
        """Wait for a dispatched batch's decoded arrays and convert them to
        KITTI annotations, or to the visualization format."""
        per_image = split_batch_detections(fetch_detection(dispatched),
                                           TEST_SCORE_THRESHOLD)
        if vis_format:
            return to_vis_format(per_image)
        return {
            "img_bbox": convert_to_kitti_3d(
                per_image, batch["img_metas"], batch["calib"]
            ),
            "img_bbox2d": convert_to_kitti_2d(per_image, batch["img_metas"]),
        }

    def _collect_eval(self, dispatched, batch) -> Dict[str, List]:
        """A dispatched batch's KITTI annotations, its padding rows
        dropped."""
        return {k: self._valid_rows(v, batch) for k, v in
                self._finalize_eval(dispatched, batch).items()}

    def run_eval_batch(self, batch: Dict[str, Any], vis_format: bool = False):
        """One loader batch through the whole path, unpipelined."""
        self.model.eval()
        with self._on_device():
            return self._finalize_eval(self._dispatch_eval(batch), batch,
                                       vis_format=vis_format)

    def visualize(self, output_dir: str,
                  draw_items: Sequence[str] = ("2d", "3d", "bev")) -> None:
        """Draw each test image's detections: one PNG per image and item
        under ``output_dir/<item>/``, named as the image. Over several
        ranks, rank 0 draws every rank's detections."""
        from ..utils.visualizer import Visualizer

        per_batch: List[List[Dict[str, Any]]] = []
        scale_hw = None
        for batch in self.test_loader:
            if scale_hw is None and batch["img_metas"].get("scale_hw"):
                scale_hw = batch["img_metas"]["scale_hw"][0]
            per_batch.append(self._valid_rows(
                self.run_eval_batch(batch, vis_format=True), batch))
        per_batch = self._gather_batches(per_batch)
        if not self.is_main:
            return
        vis_container = [row for part in per_batch for row in part]
        visualizer = Visualizer(self.test_dataset, vis_container,
                                scale_hw=scale_hw)
        plot = {"2d": visualizer.plot_bboxes_2d,
                "3d": visualizer.plot_bboxes_3d, "bev": visualizer.plot_bev}
        for item in draw_items:
            save_dir = os.path.join(output_dir, item)
            os.makedirs(save_dir, exist_ok=True)
            for idx in range(len(self.test_dataset)):
                name = os.path.basename(self.test_dataset.image_path(idx))
                plot[item](idx, save_path=os.path.join(save_dir, name))
