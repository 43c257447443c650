"""Decoded-image cache: decode each training PNG once.

A copy of ``monocon_tpu/data/image_cache.py``. Every epoch decodes every
training PNG again; the cache keeps the DECODED uint8 pixels on disk after
the first access, so that later epochs replace the decode with one
sequential file read, served from the OS page cache when the set fits in
memory.

Layout: one ``<id>.npy`` per sample in the cache directory (atomic
write-through: tmp file + ``os.replace``, safe under the loader's thread
pool and under multiple processes sharing the directory). The cache stores
post-decode RGB uint8 ONLY — augmentation stays per-epoch random downstream.
Stale-cache rule: the cache never revalidates against the source PNG; clear
the directory if the underlying images change.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional

import numpy as np


class DecodedImageCache:
    """Write-through disk cache of decoded RGB uint8 images keyed by id."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.npy")

    def get(self, key: str) -> Optional[np.ndarray]:
        """The cached decoded image, or None on a miss (or unreadable
        entry — a torn file from a crashed writer reads as a miss and is
        re-decoded/rewritten, never propagated)."""
        path = self._path(key)
        if not os.path.isfile(path):
            return None
        try:
            arr = np.load(path, allow_pickle=False)
        except (OSError, ValueError):
            self._evict(path)  # unreadable: drop it so put() can rewrite
            return None
        if arr.ndim != 3 or arr.dtype != np.uint8:
            self._evict(path)
            return None
        return arr

    @staticmethod
    def _evict(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def put(self, key: str, image: np.ndarray) -> None:
        """Atomically persist a decoded image (tmp + os.replace)."""
        assert image.dtype == np.uint8 and image.ndim == 3, (
            image.dtype, image.shape)
        path = self._path(key)
        if os.path.isfile(path):
            return
        fd, tmp = tempfile.mkstemp(
            dir=self.cache_dir, prefix=f".{key}.", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, np.ascontiguousarray(image))
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(self._path(key))


def resolve_image_cache(setting: str, data_root: str,
                        split: str) -> Optional[DecodedImageCache]:
    """Config knob -> cache instance.

    ``''`` (default): off. ``'auto'``: ``{data_root}/_decoded_cache/{split}``
    (next to the data it mirrors). Any other string: used as the cache
    directory verbatim, with the split appended so train/val never collide.
    """
    if not setting:
        return None
    if setting == "auto":
        path = os.path.join(data_root, "_decoded_cache", split)
    else:
        path = os.path.join(setting, split)
    return DecodedImageCache(path)
