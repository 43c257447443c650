"""Build the port's native libraries at their first use.

Each library is compiled into the package's own ``build/`` directory, never
beside its source, under a name keyed by a hash of the source and the
compiler flags, and is then loaded with ``ctypes``. A failed build raises:
nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# Host code (the PNG unfilter, the KITTI matcher). -ffp-contract=off: the
# matcher's rotated IoU is bit-equal to its numpy version only without FMA
# contraction.
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's host libraries cannot "
                           "be built")
    return found


def build_library(source: Path, compiler: str, flags: Sequence[str]) -> Path:
    """Compile ``source`` into ``build/lib<stem>_<hash>.so`` unless that
    file exists, and return its path. The library is written to a
    temporary name and renamed into place, so that a concurrent process
    never loads half a file."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([compiler, *flags, "-o", tmp, str(source)], check=True)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path
