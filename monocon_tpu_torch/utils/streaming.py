"""Software-pipelined streaming inference for frame sequences.

A copy of ``monocon_tpu/utils/streaming.py``. The reference's raw-video
path is strictly serial per frame: host decode -> H2D -> forward -> D2H ->
vis conversion (test_raw.py:56-60). Here the three stages overlap:

  * frames i+1..i+p decode on a small thread pool (``zlib`` and the PNG
    unfilter release the interpreter lock) while
  * frame i computes on the card (``infer`` queues its work and returns
    without a synchronise: torch launches asynchronously), and
  * frame i-1's result, copied into pinned host memory behind a CUDA event
    (``engine.engine.dispatch_detection``), is waited for and converted
    to vis format on the host (``finalize``).

Wall-clock per frame then approaches max(host decode, device step, D2H)
instead of their sum. :class:`PinnedUpload` is the host-to-device half: a
ring of pinned slots, each refilled only once the copy that last read it
has completed.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

# Pinned slots of PinnedUpload: one being filled while the copies of the
# two batches before it may still be in flight.
UPLOAD_SLOTS = 3


class BatchedFrames:
    """View a per-frame dataset as fixed-size stacked uint8 batches.

    ``__getitem__(j)`` stacks frames ``j*b .. j*b+b-1`` into one
    ``{'img': (b, H, W, C), 'count': k}`` sample; the final partial batch
    is padded by repeating its last frame (``count`` tells the consumer
    how many rows are real) so every batch has one shape. Frames must
    share one resolution: callers check this up front
    (``KITTIRawDataset.frame_shape`` reads headers only). The reference's
    raw path is strictly B=1 (test_raw.py:56-65); batches trade latency for
    throughput when re-detecting a recorded drive.

    Thread-safety matches the wrapped dataset's: each call touches only
    its own frames, so it is safe under ``pipelined_frames``'s pool iff
    the wrapped ``__getitem__`` is.
    """

    def __init__(self, dataset: Sequence[Any], batch: int):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.dataset = dataset
        self.batch = batch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch)

    def __getitem__(self, j: int) -> Dict[str, Any]:
        n = len(self.dataset)
        lo = j * self.batch
        if not 0 <= lo < n:
            raise IndexError(j)
        idxs = range(lo, min(n, lo + self.batch))
        imgs = [self.dataset[i]["img"] for i in idxs]  # each (1, H, W, C)
        count = len(imgs)
        imgs += [imgs[-1]] * (self.batch - count)
        return {"img": np.concatenate(imgs, axis=0), "count": count}


def pipelined_frames(
    dataset: Sequence[Any],
    infer: Callable[[Any], Any],
    finalize: Callable[[Any, Any], Any],
    prefetch: int = 3,
    workers: int = 2,
) -> Iterator[Any]:
    """Run ``finalize(infer(sample), sample)`` over every dataset index, in
    order, with loading / device compute / result materialization
    overlapped.

    ``infer`` should queue device work and return WITHOUT waiting for the
    result; ``finalize`` waits for it one frame later, while the next
    frame computes. Yields ``finalize``'s return values in frame order.

    Thread-safety requirement: ``dataset.__getitem__`` is called from
    ``workers`` pool threads concurrently, so it must be thread-safe and
    stateless per call. ``KITTIRawDataset`` qualifies: each call opens and
    decodes its own frame file.
    """
    n = len(dataset)
    if n == 0:
        return
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        loads: deque = deque()
        for i in range(min(max(1, prefetch), n)):
            loads.append(pool.submit(dataset.__getitem__, i))
        next_i = len(loads)

        pending = None  # (dispatched, sample) of frame idx-1
        for _ in range(n):
            sample = loads.popleft().result()
            if next_i < n:
                loads.append(pool.submit(dataset.__getitem__, next_i))
                next_i += 1
            dispatched = infer(sample)
            if pending is not None:
                yield finalize(*pending)
            pending = (dispatched, sample)
        yield finalize(*pending)


class PinnedUpload:
    """Host arrays to ``device`` without a synchronise: on the card each
    array is copied into one of a ring of pinned slots and from there with
    ``non_blocking=True`` on the current stream, and a slot is refilled
    only once the event of the copy that last read it has completed. On
    the CPU the array becomes a tensor that shares its memory."""

    def __init__(self, device: "str | torch.device"):
        self.device = torch.device(device)
        self._slots: List[Optional[torch.Tensor]] = [None] * UPLOAD_SLOTS
        self._copied: List[Optional[torch.cuda.Event]] = [None] * UPLOAD_SLOTS
        self._next = 0

    def __call__(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return host.to(self.device)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        slot = self._slots[i]
        if slot is None or slot.shape != host.shape or slot.dtype != host.dtype:
            slot = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            self._slots[i] = slot
        slot.copy_(host)
        out = slot.to(self.device, non_blocking=True)
        self._copied[i] = torch.cuda.Event()
        self._copied[i].record()
        return out
