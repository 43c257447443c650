"""Where the PyTorch port's frame export spends its time, beside the JAX
package's OpenCV export of the same frames.

Writes a synthetic KITTI raw drive (PNG frames at 375x1242 and a
``calib_cam_to_cam.txt``), makes one random vis format a frame (30
detections: 3D boxes near the camera, some with corners behind it, a few
far to the side, 2D boxes some of which reach 1e5 px out), then times on
the host, frame by frame:

  * the port's ``monocon_tpu_torch.utils.visualizer.Visualizer``: frame
    decode (``KITTIRawDataset[i]``, once per 2D and 3D plot), drawing of
    each plot, the PNG write of each plot, and ``export_as_video`` as a
    whole, in one worker process and in its ``EXPORT_WORKERS``;
  * where ``cv2`` and the JAX package import, the JAX package's
    ``Visualizer`` on the same frames and vis formats: decode, drawing,
    and ``export_as_video`` (three mp4v files) as a whole.

Prints one line a measurement and, last, a JSON object of them all
(seconds per frame). Run from the repo root:

  python scripts/torch_export_timing.py [--frames 96]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from monocon_tpu_torch.utils.visualizer import EXPORT_WORKERS

RAW_HW = (375, 1242)
BOXES = 30
FAR = 100_000


def write_drive(root: str, frames: int, seed: int):
    from monocon_tpu_torch.data.png import write_png
    from monocon_tpu_torch.data.synthetic import DEFAULT_P2, render_scene

    image_dir = os.path.join(root, "image_02", "data")
    os.makedirs(image_dir)
    for i in range(frames):
        write_png(os.path.join(image_dir, f"{i:010d}.png"),
                  render_scene(np.random.default_rng((seed, i)), RAW_HW, [],
                               DEFAULT_P2))
    calib = os.path.join(root, "calib_cam_to_cam.txt")
    with open(calib, "w") as f:
        f.write("P_rect_02: " + " ".join(
            f"{v:.6e}" for v in DEFAULT_P2.reshape(-1)) + "\n")
    return image_dir, calib


def random_vis_format(rng):
    """One frame's detections in vis format."""
    from monocon_tpu_torch.data.geometry import boxes3d_to_corners

    boxes = []
    while len(boxes) < BOXES:
        loc = rng.uniform((-15, -2, -4), (15, 2.5, 45))
        dims = rng.uniform((1, 1, 1), (5, 3, 5))
        ry = rng.uniform(-np.pi, np.pi)
        if len(boxes) < 3:
            loc[0] = rng.choice([-1, 1]) * rng.uniform(5e3, 1e4)
        corners = boxes3d_to_corners(loc[None], dims[None], np.array([ry]))
        if np.abs(corners[0, :, 2]).min() < 0.2:
            continue
        boxes.append(np.concatenate([loc, dims, [ry]]))
    labels = rng.integers(0, 3, BOXES)
    scores = rng.uniform(0.1, 1.0, BOXES)
    x1y1 = rng.uniform(-40, (RAW_HW[1] + 20, RAW_HW[0] + 20), (BOXES, 2))
    wh = rng.uniform(1, 400, (BOXES, 2))
    bbox2d = np.concatenate([x1y1, x1y1 + wh, scores[:, None]], 1)
    bbox2d[:3, :2] -= FAR
    bbox2d[3:5, 2:4] += FAR
    return {"img_bbox": {"boxes_3d": np.array(boxes, np.float32),
                         "scores_3d": scores.astype(np.float32),
                         "labels_3d": labels},
            "img_bbox2d": [bbox2d[labels == c].astype(np.float32)
                           for c in range(3)]}


def per_frame(fn, n: int) -> float:
    """Seconds per call of ``fn(i)`` over frames 0..n-1."""
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) / n


def time_port(image_dir, calib, vis, out_dir):
    from monocon_tpu_torch.data.kitti_raw import KITTIRawDataset
    from monocon_tpu_torch.data.png import write_png
    from monocon_tpu_torch.data.transforms import default_raw_transforms
    from monocon_tpu_torch.utils import visualizer

    dataset = KITTIRawDataset(image_dir, calib, default_raw_transforms(True))
    n = len(dataset)
    v = visualizer.Visualizer(dataset, vis)
    v.plot_bev(0)                    # the BEV grid is drawn once, first
    res = {"decode": per_frame(lambda i: dataset[i], n)}
    plots = {"2d": v.plot_bboxes_2d, "3d": v.plot_bboxes_3d,
             "bev": v.plot_bev}
    scratch = os.path.join(out_dir, "write.png")
    for item, plot in plots.items():
        # The 2D and 3D plots decode their frame; drawing is the rest.
        decoded = res["decode"] if item != "bev" else 0.0
        images = []
        res[f"draw_{item}"] = per_frame(
            lambda i: images.append(plot(i)), n) - decoded
        res[f"write_{item}"] = per_frame(
            lambda i: write_png(scratch, images[i]), n)
    for key, workers in (("export_1_worker", 1), ("export", EXPORT_WORKERS)):
        visualizer.EXPORT_WORKERS = workers
        t0 = time.perf_counter()
        v.export_as_video(os.path.join(out_dir, key), list(plots))
        res[key] = (time.perf_counter() - t0) / n
    return res


def time_jax(image_dir, calib, vis, out_dir):
    import cv2  # noqa: F401

    from monocon_tpu.data.kitti_raw import KITTIRawDataset
    from monocon_tpu.data.transforms import default_raw_transforms
    from monocon_tpu.utils.visualizer import Visualizer

    dataset = KITTIRawDataset(image_dir, calib, default_raw_transforms(True))
    n = len(dataset)
    v = Visualizer(dataset, vis)
    res = {"decode": per_frame(lambda i: dataset[i], n)}
    for item, plot in (("2d", v.plot_bboxes_2d), ("3d", v.plot_bboxes_3d),
                       ("bev", v.plot_bev)):
        decoded = res["decode"] if item != "bev" else 0.0
        res[f"draw_{item}"] = per_frame(plot, n) - decoded
    t0 = time.perf_counter()
    v.export_as_video(os.path.join(out_dir, "jax"), ["2d", "3d", "bev"])
    res["export"] = (time.perf_counter() - t0) / n
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    vis = [random_vis_format(rng) for _ in range(args.frames)]
    out = {"frames": args.frames, "boxes": BOXES, "hw": list(RAW_HW),
           "export_workers": EXPORT_WORKERS}
    with tempfile.TemporaryDirectory() as tmp:
        image_dir, calib = write_drive(tmp, args.frames, args.seed)
        out["port"] = time_port(image_dir, calib, vis, tmp)
        try:
            import cv2  # noqa: F401

            import monocon_tpu  # noqa: F401
        except ImportError as e:
            print(f"JAX package's export not timed: {e}")
        else:
            out["jax"] = time_jax(image_dir, calib, vis, tmp)
    for side in ("port", "jax"):
        for key, s in out.get(side, {}).items():
            print(f"{side} {key}: {s:.6f} s a frame")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
