"""Batches for the device: threaded decode workers, batch assembly, and the
copy to the device ahead of use.

Port of ``monocon_tpu/data/loader.py``. :func:`collate` is a copy. The
:class:`DataLoader` keeps the JAX loader's worker threads (PNG inflate and
unfilter release the interpreter lock), its deterministic order and its
prefetch queue, and places batches on a torch device:

  * on the CPU, the arrays become tensors that share their memory;
  * on a CUDA device, the producer thread collates each batch into one of a
    small ring of pinned host canvases and copies it with
    ``non_blocking=True`` on a copy stream of its own, with the batch's
    ``label`` arrays (pinned first) for a loader made with
    ``labels=True`` (training). The batch carries the copies' CUDA event
    as ``batch['ready']``: the consumer makes its stream
    wait on it (:func:`use_on_current_stream`). A canvas is filled again only
    after the event of the copy that read it has completed.

With ``shuffle=True`` the order of each epoch is drawn from ``(seed,
epoch)``, and each sample's augmentation from ``(seed, epoch, position)``,
as there. On one rank there are no padding rows: the last batch of a split
is as short as it is. Over ``world`` ranks ``batch_size`` is the global
batch, and each rank's loader reads only its rows of it
(``parallel/mesh.py::rank_rows``), with their global positions, so that
the ranks together see the pixels and labels that one process sees; the
remainder batch is padded cyclically to the global batch, as the JAX
loader's ``pad_to_batch`` pads it, and each batch carries ``valid`` (its
rows' 0/1, a device tensor) and ``num_valid`` (the global batch's real
rows). With the image height split over ranks, ``rank`` and ``world`` are
the data shard's, and ``band`` keeps the rows of the canvas that this rank
holds: only they go to the device; labels, ``img_hw``, ``p2`` and the
metas stay whole.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import rank_rows

DEFAULT_PAD_HW = (384, 1248)
# The tensors of a batch that go to the device (and, for training, the
# arrays of its ``label`` dict).
DEVICE_KEYS = ("img", "img_hw", "p2")
# Also sent, where a batch has it: the 0/1 of a padded batch's rows.
VALID_KEY = "valid"
# Pinned canvases in the ring of the CUDA path: one being filled, one
# being copied, one in the prefetch queue.
STAGING_BUFFERS = 3


def collate(samples: List[Dict[str, Any]],
            pad_hw: Optional[Tuple[int, int]] = DEFAULT_PAD_HW,
            out_images: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Stack samples into one batch dict with numpy arrays.

    Images are placed top-left on a zeroed (pad_h, pad_w) canvas; labels
    (already fixed-shape per sample) stack to (B, O, ...); per-sample P2
    matrices stack to a (B, 3, 4) array.

    ``out_images``: optional preallocated (B, pad_h, pad_w, 3) canvas to
    fill in place (the loader's pinned ring).
    """
    if pad_hw is None:
        hs = [s["img"].shape[0] for s in samples]
        ws = [s["img"].shape[1] for s in samples]
        pad_hw = (max(hs), max(ws))
    b = len(samples)
    # Canvas dtype follows the samples: uint8 when the pipeline defers
    # normalization to the device, float32 when the host Normalize ran.
    img_dtype = samples[0]["img"].dtype
    if (out_images is not None
            and out_images.shape == (b, *pad_hw, 3)
            and out_images.dtype == img_dtype):
        images = out_images
        images.fill(0)
    else:
        images = np.zeros((b, *pad_hw, 3), img_dtype)
    for i, s in enumerate(samples):
        img = s["img"]
        h = min(img.shape[0], pad_hw[0])
        w = min(img.shape[1], pad_hw[1])
        images[i, :h, :w] = img[:h, :w]

    metas: Dict[str, List[Any]] = {}
    for s in samples:
        for k, v in s["img_metas"].items():
            metas.setdefault(k, []).append(v)
    metas["pad_shape"] = [pad_hw] * b

    # Per-sample true pixel extent (pre zero-fill): the device zeroes the
    # padded border after normalizing, so that uint8 transport matches
    # float32 transport bit-for-bit.
    img_hw = np.array(
        [s["img_metas"].get("unpadded_shape", s["img"].shape[:2])
         for s in samples],
        np.int32,
    )

    batch: Dict[str, Any] = {
        "img": images,
        "img_hw": img_hw,
        "img_metas": metas,
        "calib": [s["calib"] for s in samples],
        "p2": np.stack([s["calib"].P2 for s in samples]).astype(np.float32),
    }
    if samples[0].get("label") is not None:
        keys = samples[0]["label"].keys()
        batch["label"] = {
            k: np.stack([s["label"][k] for s in samples]).astype(np.float32)
            for k in keys
        }
    return batch


def use_on_current_stream(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The device tensors of a loader batch (and its ``label`` dict, when
    the loader moved it), ready for the current stream: on CUDA the stream
    waits for the batch's copies, and the tensors, made on the copy
    stream, are marked as used by this one for the allocator."""
    event = batch.get("ready")
    tensors = {k: batch[k] for k in (*DEVICE_KEYS, VALID_KEY) if k in batch}
    label = batch.get("label")
    if label and not isinstance(next(iter(label.values())), torch.Tensor):
        label = None        # left on the host
    if label is not None:
        tensors["label"] = label
    if event is not None:
        stream = torch.cuda.current_stream(tensors["img"].device)
        stream.wait_event(event)
        for t in (*(v for k, v in tensors.items() if k != "label"),
                  *(label.values() if label is not None else ())):
            t.record_stream(stream)
    return tensors


class DataLoader:
    """Iterates batches with background workers.

    Deterministic: per-epoch ordering and per-sample augmentation RNG are
    derived from (seed, epoch, sample position).

    Each batch holds its ``img``, ``img_hw`` and ``p2`` (with
    ``labels=True`` also its ``label`` arrays, and over several ranks its
    ``valid``) as tensors on ``device`` (see the module docstring), the
    rest as on the host. ``batch_size`` is the global batch, of which rank
    ``rank`` of ``world`` loads ``batch_size // world`` rows, and with
    ``band = (start, stop)`` sends the canvas rows ``[start, stop)`` alone
    (a static ``pad_hw`` only).
    """

    def __init__(
        self,
        dataset,
        device: "torch.device | str",
        batch_size: int = 8,
        shuffle: bool = True,
        num_workers: int = 4,
        pad_hw: Optional[Tuple[int, int]] = DEFAULT_PAD_HW,
        seed: int = 0,
        prefetch_batches: int = 2,
        labels: bool = False,
        rank: int = 0,
        world: int = 1,
        band: Optional[Tuple[int, int]] = None,
    ):
        if batch_size % world:
            raise ValueError(f"a global batch of {batch_size} does not "
                             f"split over {world} ranks")
        if band is not None and pad_hw is None:
            raise ValueError("a band of the canvas needs a static pad_hw")
        self.dataset = dataset
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        # 0 = load samples synchronously in the producer thread.
        self.num_workers = max(0, num_workers)
        self.pad_hw = pad_hw
        self.seed = seed
        self.prefetch_batches = max(1, prefetch_batches)
        self.labels = labels
        self.rank = rank
        self.world = world
        self.band = band
        self.epoch = 0
        # The pinned canvases of the CUDA path, and the event of the last
        # copy that read each.
        self._staging: List[Optional[torch.Tensor]] = [None] * STAGING_BUFFERS
        self._copied: List[Optional[torch.cuda.Event]] = (
            [None] * STAGING_BUFFERS)
        self._copy_stream: Optional[torch.cuda.Stream] = None

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def _load_one(self, idx: int, pos: int):
        rng = np.random.default_rng((self.seed, self.epoch, pos))
        if hasattr(self.dataset, "get_sample"):
            return self.dataset.get_sample(int(idx), rng)
        return self.dataset[int(idx)]

    def _pinned_canvas(self, slot: int, samples) -> torch.Tensor:
        """The slot's pinned canvas, cut to this batch's shape, once the
        copy that last read it has completed."""
        event = self._copied[slot]
        if event is not None:
            event.synchronize()
            self._copied[slot] = None
        pad_hw = self.pad_hw or (max(s["img"].shape[0] for s in samples),
                                 max(s["img"].shape[1] for s in samples))
        dtype = torch.from_numpy(samples[0]["img"][:0]).dtype
        if self.band is not None:
            pad_hw = (self.band[1] - self.band[0], pad_hw[1])
        shape = (self.batch_size // self.world, *pad_hw, 3)
        canvas = self._staging[slot]
        if canvas is None or canvas.shape != shape or canvas.dtype != dtype:
            canvas = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._staging[slot] = canvas
        return canvas[:len(samples)]

    def _to_device(self, batch: Dict[str, Any], slot: int,
                   canvas: Optional[torch.Tensor]) -> None:
        """Replace the batch's device keys (and with ``labels`` its label
        arrays) by tensors on ``self.device``; on CUDA the image comes from
        ``canvas``, which collate filled."""
        host = {k: torch.from_numpy(batch[k])
                for k in (*DEVICE_KEYS, VALID_KEY) if k in batch}
        label = ({k: torch.from_numpy(v) for k, v in batch["label"].items()}
                 if self.labels and "label" in batch else {})
        if self.device.type != "cuda":
            batch.update({k: v.to(self.device) for k, v in host.items()})
            if label:
                batch["label"] = {k: v.to(self.device)
                                  for k, v in label.items()}
            return
        host["img"] = canvas
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            batch.update({k: v.to(self.device, non_blocking=True)
                          for k, v in host.items()})
            if label:
                # Pinned by the caching host allocator, which reuses a
                # block only once the copies recorded on it have completed.
                batch["label"] = {
                    k: v.pin_memory().to(self.device, non_blocking=True)
                    for k, v in label.items()}
            event = torch.cuda.Event()
            event.record()
        batch["ready"] = event
        self._copied[slot] = event

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._epoch_order()
        batch_starts = list(range(0, len(order), self.batch_size))

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        pinned = self.device.type == "cuda"
        if pinned and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)

        def producer():
            try:
                pool = (ThreadPoolExecutor(self.num_workers)
                        if self.num_workers > 0 else None)
                try:
                    for bi, start in enumerate(batch_starts):
                        if stop.is_set():
                            return
                        num_real = min(self.batch_size, len(order) - start)
                        rows = (rank_rows(self.batch_size, num_real,
                                          self.rank, self.world)
                                if self.world > 1 else
                                [(j, True) for j in range(num_real)])
                        positions = [start + j for j, _ in rows]
                        idxs = order[positions]
                        if pool is None:
                            samples = [self._load_one(i, p)
                                       for i, p in zip(idxs, positions)]
                        else:
                            samples = list(
                                pool.map(self._load_one, idxs, positions)
                            )
                        slot = bi % STAGING_BUFFERS
                        canvas = (self._pinned_canvas(slot, samples)
                                  if pinned else None)
                        banded = self.band is not None
                        batch = collate(
                            samples, self.pad_hw,
                            out_images=(None if canvas is None or banded
                                        else canvas.numpy()))
                        if banded:
                            band = batch["img"][:, slice(*self.band)]
                            if canvas is None:
                                batch["img"] = np.ascontiguousarray(band)
                            else:
                                canvas.numpy()[:] = band
                        if self.world > 1:
                            batch[VALID_KEY] = np.array(
                                [v for _, v in rows], np.float32)
                            batch["num_valid"] = num_real
                        self._to_device(batch, slot, canvas)
                        out_q.put(batch)
                finally:
                    if pool is not None:
                        pool.shutdown(wait=False)
                out_q.put(None)
            except BaseException as exc:  # propagate to the consumer
                out_q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            # A consumer that stops early: drain until the producer has
            # seen the stop and exited, so that it never blocks on a full
            # queue (it finishes at most the batch it is on).
            stop.set()
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
