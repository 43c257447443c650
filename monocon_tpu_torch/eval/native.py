"""ctypes binding for the C++ matching library.

Port of ``monocon_tpu/eval/native.py``. ``cpp/kitti_match.cpp`` is a copy of
the JAX package's source, built with the same flags (``-O3
-ffp-contract=off``) at its first use into the package's ``build/``
directory, keyed by a hash of the source. Unlike the JAX package's binding
there is no silent fallback and no pure-Python matcher: a failed build or
bind raises. The port's tests hold the matcher against the JAX package's
evaluator.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..utils.native_build import GXX_FLAGS, build_library, gxx

SOURCE = Path(__file__).resolve().parent / "cpp" / "kitti_match.cpp"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """Build if needed, then load and bind the matcher library."""
    with _lib_lock:
        if _lib is None:
            _bind(ctypes.CDLL(str(build_library(SOURCE, gxx(), GXX_FLAGS))))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    global _lib
    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)
    lib.fused_pr.restype = None
    lib.fused_pr.argtypes = [
        c_double_p, c_int64_p,           # overlaps, overlap_offsets
        c_double_p, c_int64_p,           # gt_alphas, gt_offsets
        c_double_p, c_double_p,          # dt_alphas, dt_scores
        c_double_p, c_int64_p,           # dt_bboxes, dt_offsets
        c_int64_p, c_int64_p,            # ignored_gt, ignored_dt
        c_double_p, c_int64_p,           # dc_bboxes, dc_offsets
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        c_double_p, ctypes.c_int64, ctypes.c_int64,
        c_double_p,
    ]
    lib.thresh_scores.restype = ctypes.c_int64
    lib.thresh_scores.argtypes = [
        c_double_p, c_int64_p,           # overlaps, overlap_offsets
        c_double_p, c_int64_p,           # dt_scores, dt_offsets
        c_int64_p, c_int64_p,            # ignored_gt, gt_offsets
        c_int64_p,                       # ignored_dt
        ctypes.c_int64, ctypes.c_double,
        c_double_p,                      # out_scores (>= total_gt)
    ]
    lib.rotate_pairs_kernel.restype = None
    lib.rotate_pairs_kernel.argtypes = [
        c_double_p, c_double_p,          # boxes (P,5), qboxes (P,5)
        c_double_p, c_double_p,          # area1 (P,), area2 (P,)
        ctypes.c_int64, ctypes.c_int64,  # P, criterion
        ctypes.POINTER(ctypes.c_float),  # out (P,)
    ]
    _lib = lib
    return _lib


def _ptr_d(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_i(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _offsets(counts: List[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _cat(image_args: List[Dict[str, np.ndarray]], key: str,
         dtype=np.float64) -> np.ndarray:
    """Flatten-and-concatenate one per-image array across all images into
    a single contiguous buffer for the C++ kernels."""
    arrs = [np.ascontiguousarray(a[key], dtype=dtype).reshape(-1)
            for a in image_args]
    out = (np.concatenate(arrs) if arrs else np.zeros(0, dtype))
    return np.ascontiguousarray(out, dtype=dtype)


def rotate_pairs_native(
    boxes64: np.ndarray, qboxes64: np.ndarray,
    area1: np.ndarray, area2: np.ndarray, criterion: int,
) -> np.ndarray:
    """Elementwise rotated overlap for P aligned pairs via the C++ kernel
    (``rotate_pairs_kernel``).

    Inputs must be float64 (the caller — rotate_iou.rotate_iou_pairs —
    owns the dtype quirks: areas are multiplied in the original input
    dtype, then widened). Outputs are bit-identical float32 to the JAX
    package's numpy clip; see the kernel's bit-exactness contract in
    cpp/kitti_match.cpp."""
    lib = get_lib()
    p = boxes64.shape[0]
    boxes64 = np.ascontiguousarray(boxes64, np.float64)
    qboxes64 = np.ascontiguousarray(qboxes64, np.float64)
    area1 = np.ascontiguousarray(area1, np.float64)
    area2 = np.ascontiguousarray(area2, np.float64)
    out = np.empty(p, np.float32)
    lib.rotate_pairs_kernel(
        _ptr_d(boxes64), _ptr_d(qboxes64), _ptr_d(area1), _ptr_d(area2),
        p, int(criterion),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


class FlatPack:
    """Flattened, offset-indexed buffers for the C++ kernels, built ONCE
    per :func:`protocol.eval_class` call.

    Everything except the ignore codes is class/difficulty-invariant;
    ``set_ignored_flat`` swaps only the per-(class, difficulty) ignore
    codes, which must be set before the first match.
    """

    def __init__(self, image_args: List[Dict[str, np.ndarray]]):
        self.gt_off = _offsets([len(a["gt_alphas"]) for a in image_args])
        self.dt_off = _offsets([len(a["dt_scores"]) for a in image_args])
        self.dc_off = _offsets([len(a["dc_bboxes"]) for a in image_args])
        self.ov_off = _offsets([a["overlaps"].size for a in image_args])
        self.n_images = len(image_args)
        self.overlaps = _cat(image_args, "overlaps")
        self.gt_alphas = _cat(image_args, "gt_alphas")
        self.dt_alphas = _cat(image_args, "dt_alphas")
        self.dt_scores = _cat(image_args, "dt_scores")
        self.dt_bboxes = _cat(image_args, "dt_bboxes")
        if self.dt_bboxes.size == 0:
            self.dt_bboxes = np.zeros(4)
        self.dc_bboxes = _cat(image_args, "dc_bboxes")
        if self.dc_bboxes.size == 0:
            self.dc_bboxes = np.zeros(4)
        self.total_gt = int(self.gt_off[-1])
        self.ignored_gt: Optional[np.ndarray] = None
        self.ignored_dt: Optional[np.ndarray] = None

    def set_ignored_flat(self, ignored_gt: np.ndarray,
                         ignored_dt: np.ndarray) -> None:
        """Set the ignore codes from flat arrays (the
        ``protocol._clean_all_from_flat`` output)."""
        assert len(ignored_gt) == self.total_gt
        assert len(ignored_dt) == int(self.dt_off[-1])
        self.ignored_gt = np.ascontiguousarray(ignored_gt, np.int64)
        self.ignored_dt = np.ascontiguousarray(ignored_dt, np.int64)


def batch_match(
    pack: FlatPack,
    metric: int,
    min_overlap: float,
    thresholds: np.ndarray,
    compute_aos: bool,
) -> np.ndarray:
    """Accumulated PR table (T, 4): tp, fp, fn, similarity, over all
    images of ``pack`` (reused across (class, difficulty, regime) by
    ``eval_class``)."""
    lib = get_lib()
    thresholds = np.ascontiguousarray(thresholds, np.float64)
    pr = np.zeros((len(thresholds), 4), np.float64)
    lib.fused_pr(
        _ptr_d(pack.overlaps), _ptr_i(pack.ov_off),
        _ptr_d(pack.gt_alphas), _ptr_i(pack.gt_off),
        _ptr_d(pack.dt_alphas), _ptr_d(pack.dt_scores),
        _ptr_d(pack.dt_bboxes), _ptr_i(pack.dt_off),
        _ptr_i(pack.ignored_gt), _ptr_i(pack.ignored_dt),
        _ptr_d(pack.dc_bboxes), _ptr_i(pack.dc_off),
        pack.n_images, metric, float(min_overlap),
        _ptr_d(thresholds), len(thresholds), int(compute_aos),
        _ptr_d(pr),
    )
    return pr


def batch_match_scores(
    pack: FlatPack,
    metric: int,
    min_overlap: float,
) -> np.ndarray:
    """Matched-TP scores at thresh=0 over all images (the input to
    select_thresholds) — the loop the reference numba-``prange``d
    (eval.py:128-133 caller)."""
    lib = get_lib()
    out_scores = np.zeros(max(1, pack.total_gt), np.float64)
    n = lib.thresh_scores(
        _ptr_d(pack.overlaps), _ptr_i(pack.ov_off),
        _ptr_d(pack.dt_scores), _ptr_i(pack.dt_off),
        _ptr_i(pack.ignored_gt), _ptr_i(pack.gt_off),
        _ptr_i(pack.ignored_dt),
        pack.n_images, float(min_overlap),
        _ptr_d(out_scores),
    )
    return out_scores[:n]
