"""Max-composited Gaussian splatting: the CUDA kernel and its plain version.

Port of ``monocon_tpu/ops/pallas_splat.py`` (the TPU kernel) and of the
dense ``splat_max_heatmap`` in ``monocon_tpu/ops/gaussian.py``.
:func:`splat_max_heatmap` dispatches on the tensors' device: CPU tensors go
to :func:`splat_max_heatmap_plain`, CUDA tensors to the kernel
(``csrc/splat.cu``) through :func:`splat_max_heatmap_cuda`, which raises if
the kernel cannot be built or launched. Nothing falls back.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into the package's own
``build/`` directory at its first use, keyed by a hash of the source and the
flags, and loaded with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "splat.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# The output tile one block of the kernel owns: channels x rows x columns.
TILE_C, TILE_H, TILE_W = 5, 32, 32
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", f"-DSPLAT_TILE_C={TILE_C}",
              f"-DSPLAT_TILE_H={TILE_H}", f"-DSPLAT_TILE_W={TILE_W}")
# What the kernel's C function returns when a batch element's N instances
# do not fit its shared-memory list (20 bytes each) on the device.
TOO_MANY_INSTANCES = -1

# float32 machine epsilon: values below it are dropped.
F32_EPS = float(torch.finfo(torch.float32).eps)

# Launches of the CUDA kernel since the count was last set to 0.
launch_count = 0

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the splat kernel cannot be built")
    return nvcc


def build() -> Path:
    """Compile ``csrc/splat.cu`` into a shared library (once per hash of
    the source and the flags) and return its path."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libsplat_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its C signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.splat_max_heatmap.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.splat_max_heatmap.restype = ctypes.c_int
        _lib = lib
    return _lib


def splat_max_heatmap_cuda(centers_xy: torch.Tensor, radius: torch.Tensor,
                           channel_id: torch.Tensor, valid: torch.Tensor,
                           num_channels: int, feat_h: int,
                           feat_w: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream -> (B, C, H, W) f32."""
    global launch_count
    b, n = radius.shape
    index = radius.get_device()   # -1 on the CPU
    pair = (b, n)
    for name, t, dtype, shape in (
        ("centers_xy", centers_xy, torch.int32, (b, n, 2)),
        ("radius", radius, torch.int32, pair),
        ("channel_id", channel_id, torch.int32, pair),
        ("valid", valid, torch.bool, pair),
    ):
        # One cheap test per tensor on the way through; the message only
        # when it fails.
        if (index < 0 or t.get_device() != index or t.dtype != dtype
                or t.shape != shape):
            raise ValueError(
                f"{name}: want a {dtype} tensor of shape {shape} on the "
                f"CUDA device of radius, got {t.device} {t.dtype} "
                f"{tuple(t.shape)} (radius on {radius.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load()
    out = torch.empty((b, num_channels, feat_h, feat_w), dtype=torch.float32,
                      device=radius.device)
    if out.numel() == 0:
        return out
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = lib.splat_max_heatmap(
            centers_xy.data_ptr(), radius.data_ptr(), channel_id.data_ptr(),
            valid.data_ptr(), out.data_ptr(), b, n, num_channels, feat_h,
            feat_w, torch.cuda.current_stream(index).cuda_stream)
    if err == TOO_MANY_INSTANCES:
        raise ValueError(f"{n} instances per batch element do not fit the "
                         "splat kernel's shared-memory list on this device")
    if err != 0:
        raise RuntimeError(f"splat kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out


def splat_max_heatmap_plain(centers_xy: torch.Tensor, radius: torch.Tensor,
                            channel_id: torch.Tensor, valid: torch.Tensor,
                            num_channels: int, feat_h: int,
                            feat_w: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every instance's Gaussian over
    the whole map, (B, N, H, W), then a per-channel masked max."""
    device = radius.device
    cx = centers_xy[..., 0].to(torch.float32)[:, :, None, None]  # (B, N, 1, 1)
    cy = centers_xy[..., 1].to(torch.float32)[:, :, None, None]
    r = radius.to(torch.float32)[:, :, None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)

    dx = torch.arange(feat_w, dtype=torch.float32, device=device) - cx  # (B,N,1,W)
    dy = (torch.arange(feat_h, dtype=torch.float32, device=device)[:, None]
          - cy)                                                     # (B,N,H,1)
    in_box = (dx.abs() <= r) & (dy.abs() <= r)
    # The kernel's float32 argument; exp in float64, rounded to float32, is
    # the correctly rounded value. torch's float32 CPU exp is not always:
    # on the first multithreaded call in a process one thread's share can
    # come out up to 1.5e-4 off (torch 2.13, AVX-512).
    g = torch.exp((-(dx * dx + dy * dy) * inv_2s2).double()).float()
    g = torch.where(in_box & (g >= F32_EPS) & valid[:, :, None, None], g, 0.0)
    if g.shape[1] == 0:
        return torch.zeros((g.shape[0], num_channels, feat_h, feat_w),
                           dtype=torch.float32, device=device)
    return torch.stack(
        [torch.where((channel_id == c)[:, :, None, None], g, 0.0).amax(dim=1)
         for c in range(num_channels)],
        dim=1,
    )


def splat_max_heatmap(centers_xy: torch.Tensor, radius: torch.Tensor,
                      channel_id: torch.Tensor, valid: torch.Tensor,
                      num_channels: int, feat_h: int,
                      feat_w: int) -> torch.Tensor:
    """Max-composite truncated Gaussians onto (B, C, H, W) float32 maps.

    centers_xy (B, N, 2) int32 integer centres (x, y); radius (B, N) int32;
    channel_id (B, N) int32; valid (B, N) bool. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if radius.device.type == "cpu":
        return splat_max_heatmap_plain(centers_xy, radius, channel_id, valid,
                                       num_channels, feat_h, feat_w)
    return splat_max_heatmap_cuda(centers_xy, radius, channel_id, valid,
                                  num_channels, feat_h, feat_w)
