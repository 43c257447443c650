"""Video inference on a KITTI raw drive with the port, on the card.

    python -m monocon_tpu_torch.test_raw --data_dir drive/image_02/data \\
        --calib_file drive/calib_cam_to_cam.txt \\
        --checkpoint_file model.pth --save_dir raw_results --batch 8

The flags of the root ``test_raw.py``: --data_dir (the drive's PNG
frames), --calib_file (``calib_cam_to_cam.txt``), --checkpoint_file (a
reference-format ``.pth``, or a checkpoint directory of the port's
training), --gpu_id (runs on ``cuda:<gpu_id>``), --save_dir, --fps,
--score_threshold and --batch. ``--device`` names another device, e.g.
``cpu``; without it and without a card the command fails.

DLA-34 in float32. Frames cross to the device as uint8 through a pinned
ring and are normalised there; frame decode (threads), the forward and
3D decode, and the copy back overlap (``utils/streaming.py``). Then the
detections are drawn and written as PNG sequences, ``<save_dir>/2d/``,
``3d/`` and ``bev/``, numbered ``000000.png`` on: this differs from the
JAX package's ``2d.mp4``/``3d.mp4``/``bev.mp4``, since the card's machine
has no video encoder; ``--fps`` is the rate to give an encoder.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MonoCon raw-drive "
                                     "inference (PyTorch port)")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="directory with the drive's PNG frames")
    parser.add_argument("--calib_file", type=str, required=True,
                        help="calib_cam_to_cam.txt of the drive")
    parser.add_argument("--checkpoint_file", type=str, required=True,
                        help="reference-format .pth, or a checkpoint "
                             "directory holding state.pth")
    parser.add_argument("--gpu_id", type=int, default=0,
                        help="the card to run on, cuda:<gpu_id>")
    parser.add_argument("--device", type=str, default=None,
                        help="run on this device instead, e.g. cpu")
    parser.add_argument("--save_dir", type=str, default="./raw_results")
    parser.add_argument("--fps", type=int, default=25,
                        help="frame rate to give an encoder: the frames are "
                             "written as PNG sequences (2d/, 3d/, bev/), not "
                             "as the JAX package's 2d.mp4/3d.mp4/bev.mp4; "
                             "e.g. ffmpeg -framerate FPS -i 2d/%%06d.png")
    parser.add_argument("--score_threshold", type=float, default=0.4)
    parser.add_argument("--batch", type=int, default=1,
                        help="frames per device step. 1 = lowest-latency "
                             "online streaming; larger batches trade "
                             "latency for throughput when re-detecting a "
                             "recorded drive offline")
    return parser.parse_args(argv)


def make_stream(model, dataset, device, batch: int, score_threshold: float):
    """(frames, infer, finalize) of ``pipelined_frames`` over ``dataset``
    (a ``KITTIRawDataset`` of uint8 frames) in batches of ``batch``:
    ``infer`` queues a batch's copy to ``device``, normalisation, forward
    and 3D decode without waiting; ``finalize`` waits for its copy back and
    returns the vis format of its real frames."""
    from .engine.engine import dispatch_detection, fetch_detection
    from .utils.convert import split_batch_detections, to_vis_format
    from .utils.streaming import BatchedFrames, PinnedUpload

    # The calib and the true extent are drive-wide: upload once.
    sample0 = dataset[0]
    p2 = torch.from_numpy(np.tile(
        sample0["calib"][0].P2[None].astype(np.float32), (batch, 1, 1)
    )).to(device)
    img_hw = torch.from_numpy(np.tile(
        np.array(sample0["img_metas"]["unpadded_shape"], np.int64),
        (batch, 1))).to(device)
    upload = PinnedUpload(device)

    def infer(sample):
        """Queue one frame batch; returns without waiting for the card."""
        return dispatch_detection(model, upload(sample["img"]), img_hw, p2)

    def finalize(dispatched, sample):
        """Wait for the batch's copy and convert it (while the next batch
        computes); padded repeat-frames are dropped via ``count``."""
        per_image = split_batch_detections(fetch_detection(dispatched),
                                           score_threshold)
        return to_vis_format(per_image[: sample["count"]])

    return BatchedFrames(dataset, batch), infer, finalize


def main(argv=None) -> int:
    args = parse_args(argv)
    from .data.kitti_raw import KITTIRawDataset
    from .data.transforms import default_raw_transforms
    from .device import resolve_device
    from .engine.checkpoint import STATE_FILE, load_weights
    from .engine.engine import fetch_detection
    from .models.detector import create_detector
    from .utils.streaming import pipelined_frames
    from .utils.visualizer import Visualizer

    if args.device is not None:
        device = torch.device(args.device)
    else:
        resolve_device()  # raises without a card
        device = torch.device("cuda", args.gpu_id)

    # uint8 frames, normalised on the device (4x fewer bytes to copy).
    dataset = KITTIRawDataset(
        args.data_dir, args.calib_file,
        transforms=default_raw_transforms(device_normalize=True))
    print(f"{len(dataset)} frames found.", flush=True)
    # One resolution for the whole drive (KITTI drives have one): one
    # batch shape, and the last batch padded by repeating its frame.
    # frame_shape reads the PNG headers only.
    raw_hw0 = dataset.frame_shape(0)
    for i in range(1, len(dataset)):
        hw_i = dataset.frame_shape(i)
        if hw_i != raw_hw0:
            raise SystemExit(
                f"frame {i} is {hw_i}, differing from frame 0's {raw_hw0} "
                "resolution; batched streaming needs a uniform-resolution "
                "drive")

    path = args.checkpoint_file
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        path = os.path.join(path, STATE_FILE)
    model = create_detector(34, device=device).eval()
    load_weights(path, model)

    frames, infer, finalize = make_stream(model, dataset, device, args.batch,
                                          args.score_threshold)
    on_device = (torch.cuda.device(device) if device.type == "cuda"
                 else contextlib.nullcontext())
    with on_device:
        # Warm up outside the timed window, and drain the device queue.
        fetch_detection(infer(frames[0]))
        t0 = time.perf_counter()
        results = []
        for vis in pipelined_frames(frames, infer, finalize):
            results.extend(vis)
        stream_s = time.perf_counter() - t0
    print(f"Streamed {len(dataset)} frames in {stream_s:.2f}s "
          f"({len(dataset) / stream_s:.1f} fps end-to-end: decode + "
          f"forward + 3D decode, pipelined"
          + (f", batch {args.batch}" if args.batch > 1 else "") + ").",
          flush=True)

    t0 = time.perf_counter()
    Visualizer(dataset, results).export_as_video(
        args.save_dir, ["2d", "3d", "bev"], args.fps)
    export_s = time.perf_counter() - t0
    print(f"Frames exported to '{args.save_dir}' as PNG sequences "
          f"(2d/, 3d/, bev/) in {export_s:.2f}s "
          f"({export_s / len(dataset):.4f} s per frame).", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
