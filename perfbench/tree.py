"""The benchmark's synthetic KITTI trees, written once and reused.

A configuration's ``data`` entry fixes the tree as KITTI itself is fixed:
its seed, image size and objects an image (1 to ``max_objects``, uniform).
Each split a cell reads is written under ``perfbench/cache/kitti/`` in a
directory named by those values, in the KITTI layout
(``training/{image_2,calib,label_2}``, ``ImageSets/<split>.txt``), by the
program's synthetic generator (``monocon_tpu_torch.data.synthetic``), one
process per CPU. Image ``i`` of a split draws its labels from
``default_rng((seed, split, i))`` and its pixels from ``default_rng((seed,
split, i, 1))``, so the tree does not depend on the number of processes.
A tree is written into ``<name>.partial`` and renamed when whole: a run
that finds the name reuses it.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

SPLIT_CODES = {"train": 0, "val": 1}
CACHE = Path(__file__).resolve().parent / "cache" / "kitti"


def tree_name(data: Dict, split: str, count: int) -> str:
    h, w = data["image_hw"]
    return (f"{split}{count}-seed{data['seed']}-{h}x{w}"
            f"-objs{data['max_objects']}")


def _write_image(args: Tuple[str, Dict, str, int]) -> None:
    import numpy as np

    from monocon_tpu_torch.data.png import write_png
    from monocon_tpu_torch.data.synthetic import (DEFAULT_IMAGE_HW, DEFAULT_P2,
                                                  PAETH, make_calib_text,
                                                  random_scene_labels,
                                                  render_scene)

    root, data, split, i = args
    hw = tuple(data["image_hw"])
    p2 = DEFAULT_P2.copy()
    p2[0] *= hw[1] / DEFAULT_IMAGE_HW[1]
    p2[1] *= hw[0] / DEFAULT_IMAGE_HW[0]
    key = (int(data["seed"]), SPLIT_CODES[split], i)
    rng = np.random.default_rng(key)
    lines, specs = random_scene_labels(
        rng, int(rng.integers(1, data["max_objects"] + 1)), p2, hw)
    sid = f"{i:06d}"
    sub = os.path.join(root, "training")
    with open(os.path.join(sub, "calib", f"{sid}.txt"), "w") as f:
        f.write(make_calib_text(p2))
    with open(os.path.join(sub, "label_2", f"{sid}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    write_png(os.path.join(sub, "image_2", f"{sid}.png"),
              render_scene(np.random.default_rng(key + (1,)), hw, specs, p2),
              filter_type=PAETH)


def ensure_tree(data: Dict, split: str, count: int, cache: Path = CACHE,
                workers: int = 0) -> str:
    """The root of the split's tree under ``cache``, written first if it
    is missing."""
    root = Path(cache) / tree_name(data, split, count)
    if root.is_dir():
        return str(root)
    partial = root.with_name(root.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    for sub in ("image_2", "calib", "label_2"):
        (partial / "training" / sub).mkdir(parents=True)
    (partial / "ImageSets").mkdir()
    workers = workers or min(8, os.cpu_count() or 1)
    jobs = [(str(partial), data, split, i) for i in range(count)]
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for _ in pool.map(_write_image, jobs, chunksize=4):
            pass
    (partial / "ImageSets" / f"{split}.txt").write_text(
        "".join(f"{i:06d}\n" for i in range(count)))
    os.replace(partial, root)
    return str(root)
