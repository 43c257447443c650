"""The plain reference against the port at small sizes on the CPU: each
configuration's reference model (its state dict keys and its FLOP
count), the forward, the targets, the losses, the optimizer, the PNG
decode and the loader's batches."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.counts.flops import count_flops, train_flops
from perfbench.drivers import port_cfg
from perfbench.reference import data as ref_data
from perfbench.reference import step as ref_step
from perfbench.tree import ensure_tree
from perfbench.weights import seeded_state_dict

ROOT = Path(__file__).resolve().parents[2]
DATA = {"seed": 3, "image_hw": [60, 150], "max_objects": 6}
CONFIGS = {c["name"]: c["file"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return ensure_tree(DATA, "train", 8, tmp_path_factory.mktemp("kitti"),
                       workers=2)


def port_model(depth, weights):
    from monocon_tpu_torch.models.detector import create_detector

    model = create_detector(depth, device="cpu")
    model.load_state_dict(weights)
    return model


def configuration(name):
    return json.loads((ROOT / CONFIGS[name]).read_text())


def program_model(config):
    """The program's detector as the engine builds it from the
    configuration's ``cfg``."""
    from monocon_tpu_torch.models.detector import MonoConDetector

    cfg = port_cfg(config, "", "", 0)
    return MonoConDetector(cfg.MODEL.BACKBONE.NUM_LAYERS,
                           cfg.MODEL.HEAD.NUM_CLASSES)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_keys_and_shapes_match(name):
    config = configuration(name)
    port = program_model(config).state_dict()
    ref = check.reference_module(config).build(config["model"]).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_flops_equal_the_programs(name):
    """The reference's count on the meta device, against the program's
    forward and backward on the CPU, at the tests' small size."""
    config = configuration(name)
    model = program_model(config).train()
    image = torch.zeros(4, 96, 320, 3)

    def fwd_bwd():
        out = model(image)
        sum(v.float().mean() for v in out.values()).backward()

    assert train_flops(config, 4, (96, 320)) == count_flops(fwd_bwd)


def batch_of(tree, positions, augment, seed=9):
    ids = ref_data.split_ids(tree, "train")
    order = ref_data.epoch_order(len(ids), seed, 1, shuffle=True)
    return ref_data.make_batch(tree, [ids[i] for i in order[positions]], seed,
                               1, positions, augment, (48, 128), (64, 160))


def test_loader_batches_equal_the_reference(tree):
    from monocon_tpu_torch.data.loader import DataLoader
    from monocon_tpu_torch.data.monocon_dataset import MonoConDataset
    from monocon_tpu_torch.data.transforms import default_train_transforms

    ds = MonoConDataset(tree, "train", transforms=default_train_transforms(
        (48, 128), device_normalize=True))
    loader = DataLoader(ds, "cpu", batch_size=2, num_workers=2,
                        pad_hw=(64, 160), seed=9, labels=True)
    loader.set_epoch(1)
    for i, batch in enumerate(loader):
        ref = batch_of(tree, list(range(2 * i, 2 * i + 2)), augment=True)
        prog = {k: batch[k].numpy() for k in ("img", "img_hw", "p2")}
        prog["label"] = {k: v.numpy() for k, v in batch["label"].items()}
        assert check.batch_diff(prog, ref) == 0
        assert ref["label"]["mask"].shape == (2, 30)


@pytest.mark.parametrize("kind", range(5))
def test_png_decode_equals_the_port(tmp_path, kind):
    from monocon_tpu_torch.data.png import read_png, write_png

    rng = np.random.default_rng(kind)
    paths = []
    for i in range(2):
        img = rng.integers(0, 256, (7, 11, 3), np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        write_png(paths[-1], img, filter_type=kind)
    for path, got in zip(paths, ref_data.read_pngs(paths)):
        np.testing.assert_array_equal(got, read_png(path))


def random_labels(b, rng, o=30, fill=12):
    """Labels of ``fill`` objects an image on a 64x160 canvas, keypoints
    partly off the map."""
    x0 = rng.uniform(0, 120, (b, o))
    y0 = rng.uniform(0, 40, (b, o))
    box = np.stack([x0, y0, x0 + rng.uniform(8, 40, (b, o)),
                    y0 + rng.uniform(8, 24, (b, o))], -1)
    mask = np.zeros((b, o), np.float32)
    mask[:, :fill] = 1
    b3d = np.concatenate([rng.normal(0, 5, (b, o, 3)),
                          rng.uniform(1, 4, (b, o, 3)),
                          rng.uniform(-4, 4, (b, o, 1))], -1)
    labels = {"gt_bboxes": box, "gt_labels": rng.integers(0, 3, (b, o)),
              "gt_bboxes_3d": b3d, "depths": rng.uniform(5, 60, (b, o)),
              "gt_kpts_2d": rng.uniform(-20, 180, (b, o, 18)),
              "gt_kpts_valid_mask": rng.integers(0, 3, (b, o, 9)),
              "mask": mask}
    return {k: torch.as_tensor((v * (mask if v.ndim == 2 else
                                     mask[..., None])).astype(np.float32))
            for k, v in labels.items()}


def test_forward_targets_and_losses_match_the_port(tree):
    from monocon_tpu_torch.engine.train_step import compute_losses
    from monocon_tpu_torch.ops.image_norm import normalize_if_raw
    from monocon_tpu_torch.ops.targets import generate_targets

    batch = check._to(batch_of(tree, [0, 1, 2, 3], augment=False), "cpu")
    batch["label"] = random_labels(4, np.random.default_rng(1))
    config = configuration("dla34-f32")
    ref = check.reference_module(config).build(config["model"])
    weights = seeded_state_dict(ref.state_dict(), 5, torch.device("cpu"))
    port = port_model(34, weights).train()
    ref.load_state_dict(weights)
    img = normalize_if_raw(batch["img"], batch["img_hw"])
    torch.testing.assert_close(ref_step.normalize(batch["img"],
                                                  batch["img_hw"]), img,
                               rtol=0, atol=0)
    pred, rpred = port(img), ref(img)
    for k in pred:
        # float32 on both sides: 1e-4 of the map's largest value.
        scale = max(1.0, float(rpred[k].abs().max()))
        torch.testing.assert_close(rpred[k], pred[k], rtol=1e-3,
                                   atol=1e-4 * scale)
    target = generate_targets(batch["label"], (16, 40), (64, 160))
    rt = ref_step.targets(batch["label"], (16, 40), (64, 160))
    for k in ("center_heatmap", "kpt_heatmap"):
        torch.testing.assert_close(rt[k], target[f"{k}_target"], rtol=0,
                                   atol=0)
    assert rt["mask"].sum() > 0
    losses = compute_losses(pred, target)
    rl = ref_step.losses(pred, rt)
    assert set(rl) == set(losses)
    for k in losses:
        torch.testing.assert_close(rl[k], losses[k], rtol=1e-5, atol=1e-6)


def test_adamw_and_schedule_equal_the_port_solver():
    from monocon_tpu_torch.solver.schedule import build_optimizer

    torch.manual_seed(0)
    p1 = torch.nn.Parameter(torch.randn(50))
    p2 = torch.nn.Parameter(p1.detach().clone())
    _, solver = build_optimizer([p1], lr=4.5e-4, weight_decay=1e-5,
                                total_steps=10)
    ref = ref_step.AdamW([p2], 4.5e-4, 10)
    for i in range(10):
        g = torch.randn(50) * (100.0 if i == 3 else 1.0)   # one clipped step
        p1.grad, p2.grad = g.clone(), g.clone()
        solver.step()
        ref.step()
        torch.testing.assert_close(p2.detach(), p1.detach(), rtol=1e-6,
                                   atol=1e-7)
