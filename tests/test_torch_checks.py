"""The port's convergence checks (``monocon_tpu_torch/checks/``) on the CPU
at a small canvas: the overfit's glue against the JAX package's
``scripts/overfit_check.py`` recipe (2 steps' losses from the same tree
and weights), the overfit rule, the generalization check end to end with
its record and its resume, and the snapshot median against numpy's."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from monocon_tpu.data import DataLoader as JaxLoader
from monocon_tpu.data import MonoConDataset as JaxDataset
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu.data.transforms import Normalize as JaxNormalize
from monocon_tpu.data.transforms import Pad as JaxPad
from monocon_tpu.engine import create_train_state, make_train_step
from monocon_tpu.losses import gaussian_focal_loss as jax_focal_loss
from monocon_tpu.models import heads as jax_heads
from monocon_tpu.models import create_detector_state
from monocon_tpu.solver import build_optimizer as jax_build_optimizer
from monocon_tpu_torch.checks.generalization import (run_generalization,
                                                     snapshot_medians)
from monocon_tpu_torch.checks.overfit import (overfit_passed, run_overfit,
                                              write_tree)
from monocon_tpu_torch.losses.losses import gaussian_focal_term
from monocon_tpu_torch.models import heads
from torch_port_helpers import F32_TOL, port_detector

CANVAS = (64, 160)
CROP = (48, 128)
LR = 5e-4
STEPS = 2
RESULT_KEYS = {"log", "final", "nonzero_ap", "detections", "passed",
               "train_s", "ms_per_step"}
R5_RECORD = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts",
                         "r5", "ap_seed0.json")


def jax_overfit_steps(root, steps):
    """The JAX script's body (``scripts/overfit_check.py:38-56``) at the
    small canvas: per step the variables it started from (numpy) and its
    losses, and the variables after the last step."""
    ds = JaxDataset(str(root), "train", transforms=[JaxNormalize(),
                                                    JaxPad(32)])
    loader = JaxLoader(ds, batch_size=4, shuffle=False, num_workers=2,
                       pad_hw=CANVAS, seed=0)
    batch = next(iter(loader))
    dev = {"img": jnp.asarray(batch["img"]),
           "label": {k: jnp.asarray(v) for k, v in batch["label"].items()}}
    model, variables = create_detector_state(jax.random.PRNGKey(0),
                                             image_hw=CANVAS)
    opt = jax_build_optimizer(lr=LR, total_steps=steps, use_scheduler=True)
    state = create_train_state(variables, opt)
    step = jax.jit(make_train_step(model, opt))

    def snapshot():
        return jax.tree.map(np.array, {"params": state.params,
                                       "batch_stats": state.batch_stats})

    out = []
    for _ in range(steps):
        start = snapshot()
        state, losses = step(state, dev)
        out.append((start, {k: float(v) for k, v in losses.items()}))
    return out, snapshot()


def assert_losses_match(got, want, what):
    assert got.keys() == want.keys() and len(want) == 11
    assert all(want[k] > 0 for k in ("loss_wh", "loss_dim",
                                     "loss_kpt_heatmap_offset"))
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value,
                                   err_msg=f"{what} {key}", **F32_TOL)


def test_overfit_matches_the_jax_recipe(tmp_path):
    """The JAX generator's 2-image tree, read by both packages: the port's
    ``run_overfit`` gives the JAX script's losses on both steps and its
    first update. Seed 55 leaves each image an object that the dataset's
    filter keeps at this canvas (the recipe's seed 21 leaves none), so
    that every loss term is at work.

    Step 0 and the update: both steps of the 2-step one-cycle schedule
    from JAX's initial weights. Step 0's LR is half-way down from the
    peak (10 x LR), step 1's is 1e-4 x LR, so the weights after both
    steps are those of step 0's update. AdamW's first update is
    lr * g / (|g| + eps) per element, so an element whose gradient is
    float noise moves by up to 2 lr in either package. Their share
    depends on the reduction order: 0.2% of the elements with 8 CPU
    threads, 1.0% with 1 (more than 1% of the LR off). All but 5% of the
    elements must land within 1% of the LR of where JAX moved them; a
    dropped schedule moves 99.7% of them elsewhere.

    Step 1 from the variables the JAX step started from: float32
    trajectories of the two packages part through AdamW (ROADMAP.md,
    "Numerical facts"), and the losses of a step are taken before its
    update. The BatchNorm statistics that step leaves match JAX's."""
    jax_generate(str(tmp_path), num_train=2, num_val=2, image_hw=CANVAS,
                 seed=55)
    steps, after = jax_overfit_steps(tmp_path, STEPS)
    (start, want0), (start1, want1) = steps

    model = port_detector(start)
    got = run_overfit(str(tmp_path), steps=STEPS, lr=LR, device="cpu",
                      image_hw=CANVAS, model=model)
    assert len(got["log"]) == 1
    assert_losses_match(got["log"][0], want0, "step 0")
    before = port_detector(start).state_dict()
    jax_after = port_detector(after).state_dict()
    names = [n for n, _ in model.named_parameters()]
    moved = torch.cat([(p.detach() - before[n]).flatten()
                       for n, p in model.named_parameters()])
    jax_moved = torch.cat([(jax_after[n] - before[n]).flatten()
                           for n in names])
    lr_step0 = 0.5 * 10 * LR
    assert float(jax_moved.abs().max()) == pytest.approx(lr_step0, rel=1e-3)
    off = float(((moved - jax_moved).abs() > 0.01 * lr_step0)
                .double().mean())
    assert off < 0.05, f"{off:.3%} of the elements moved elsewhere"

    model = port_detector(start1)
    got = run_overfit(str(tmp_path), steps=1, lr=LR, device="cpu",
                      image_hw=CANVAS, model=model)
    assert got["log"] == [got["final"]]
    assert_losses_match(got["final"], want1, "step 1")
    params = set(names)
    for name, value in model.state_dict().items():
        if name not in params and value.dtype.is_floating_point:
            torch.testing.assert_close(value, jax_after[name],
                                       msg=lambda m: f"{name}: {m}",
                                       **F32_TOL)


def test_run_overfit_returns_its_result(tmp_path):
    write_tree(str(tmp_path), CANVAS)
    result = run_overfit(str(tmp_path), steps=STEPS, device="cpu",
                         image_hw=CANVAS)
    assert set(result) == RESULT_KEYS
    assert len(result["log"]) == 1 and len(result["final"]) == 11
    assert all(np.isfinite(v) for v in result["final"].values())
    assert len(result["detections"]) == 4
    assert all(v > 0 for v in result["nonzero_ap"].values())
    assert result["passed"] == overfit_passed(result["final"],
                                              result["nonzero_ap"])
    assert result["ms_per_step"] == pytest.approx(
        1e3 * result["train_s"] / STEPS)


@pytest.mark.parametrize("heatmap, nonzero, passed", [
    (0.0999, 1, True), (0.1, 1, False), (0.0999, 0, False), (0.1, 0, False),
], ids=["under-one-entry", "at-limit", "no-entry", "neither"])
def test_overfit_rule(heatmap, nonzero, passed):
    """The JAX script's rule: heatmap loss under 0.1 and an AP entry above
    0 (zeros do not count)."""
    ap = {"img_bbox/KITTI/Car_3D_AP40_easy_strict": 0.0,
          "img_bbox2d/KITTI/Car_2D_AP40_easy_strict": 2.5 * nonzero}
    losses = {"loss_center_heatmap": heatmap, "total_loss": -2.4}
    assert overfit_passed(losses, ap) is passed


def perfect_detections(root, sample_indices):
    """Per image, detections equal to the labelled objects that the
    training filter keeps (occlusion <= 2, truncation <= 0.5, 2D height
    >= 25 px), read from the label files, each at score 1."""
    classes = ("Pedestrian", "Cyclist", "Car")
    per_image = []
    for idx in sample_indices:
        det = {"bboxes_2d": [], "bboxes_3d": [], "labels": [], "scores": []}
        path = os.path.join(root, "training", "label_2", f"{int(idx):06d}.txt")
        with open(path) as f:
            rows = [line.split() for line in f]
        for row in rows:
            box = [float(v) for v in row[4:8]]
            if (row[0] not in classes or int(row[2]) > 2
                    or float(row[1]) > 0.5 or box[3] - box[1] < 25):
                continue
            h, w, length, x, y, z, ry = map(float, row[8:15])
            det["bboxes_2d"].append(box + [1.0])
            det["bboxes_3d"].append([x, y, z, length, h, w, ry])
            det["labels"].append(classes.index(row[0]))
            det["scores"].append(1.0)
        per_image.append({k: np.asarray(v, np.int64 if k == "labels"
                                        else np.float64)
                          for k, v in det.items()})
    return per_image


def test_overfit_tree_caps_the_nonzero_ap_entries(tmp_path):
    """The check's own tree (192x640, seed 21) with perfect detections,
    evaluated by both packages the way their overfit checks evaluate:
    the same 84 AP entries, 36 of them nonzero, every Car and Pedestrian
    entry 0. The tree holds one valid Car and one valid Pedestrian (the
    others are under 25 px or too occluded), and a class of one object
    has one recall threshold, the point that AP40 skips. So no run of
    either package reaches more than 36 nonzero entries on this tree."""
    from monocon_tpu.utils.convert import (
        convert_to_kitti_2d as jax_kitti_2d,
        convert_to_kitti_3d as jax_kitti_3d,
    )
    from monocon_tpu_torch.checks.overfit import overfit_batch
    from monocon_tpu_torch.utils.convert import (convert_to_kitti_2d,
                                                 convert_to_kitti_3d)

    write_tree(str(tmp_path))
    dataset, host, batch = overfit_batch(str(tmp_path), torch.device("cpu"))
    per_image = perfect_detections(tmp_path, host["img_metas"]["sample_idx"])
    assert ([len(d["labels"]) for d in per_image]
            == batch["label"]["mask"].sum(1).int().tolist())
    ours = dataset.evaluate({
        "img_bbox": convert_to_kitti_3d(per_image, host["img_metas"],
                                        host["calib"]),
        "img_bbox2d": convert_to_kitti_2d(per_image, host["img_metas"]),
    }, verbose=False)

    jax_ds = JaxDataset(str(tmp_path), "train",
                        transforms=[JaxNormalize(), JaxPad(32)])
    jax_batch = next(iter(JaxLoader(jax_ds, batch_size=4, shuffle=False,
                                    num_workers=2, pad_hw=(192, 640),
                                    seed=0)))
    theirs = jax_ds.evaluate({
        "img_bbox": jax_kitti_3d(per_image, jax_batch["img_metas"],
                                 jax_batch["calib"]),
        "img_bbox2d": jax_kitti_2d(per_image, jax_batch["img_metas"]),
    }, verbose=False)

    assert ours.keys() == theirs.keys() and len(ours) == 84
    for key, value in theirs.items():
        assert ours[key] == pytest.approx(value, abs=1e-4), key
    nonzero = {k for k, v in ours.items() if v > 0}
    assert len(nonzero) == 36
    assert not any(("/Car_" in k or "/Pedestrian_" in k) for k in nonzero)


def test_generalization_writes_its_record_and_resumes(tmp_path, capsys):
    """4 train / 2 val images, 2 epochs of 2 steps at batch 2, a checkpoint
    every step, one snapshot: the record has every key of the JAX
    package's r5 record. Cut after epoch 1 (the later checkpoints and the
    record removed), the same call carries on from epoch 1's checkpoint
    and ends where the whole run ended; once done, a third call only
    evaluates."""
    out = str(tmp_path / "run")
    kwargs = dict(epochs=2, train=4, val=2, batch=2, snapshot_eval=1,
                  device="cpu", image_hw=CANVAS, crop_hw=CROP,
                  sets=[("PERIOD.CKPT_PERIOD_STEPS", "1")])
    whole = run_generalization(out, **kwargs)
    with open(R5_RECORD) as f:
        assert set(json.load(f)) | {"device", "wall_s"} == set(whole)
    with open(os.path.join(out, "ap_seed0.json")) as f:
        assert json.load(f) == whole
    assert whole["device"] == "cpu" and list(whole["snapshots"]) == ["002"]
    assert len(whole["results"]) == 84
    assert set(whole["median_results"]) == set(whole["snapshots"]["002"])
    ckpts = os.path.join(out, "checkpoints")
    final = torch.load(os.path.join(ckpts, "epoch_002_final", "state.pth"),
                       weights_only=True)["state_dict"]["model"]

    for name in ("epoch_002", "epoch_002_final"):
        shutil.rmtree(os.path.join(ckpts, name))
    os.remove(os.path.join(out, "ap_seed0.json"))
    capsys.readouterr()
    resumed = run_generalization(out, **kwargs)
    assert "epoch_001' is found and loaded" in capsys.readouterr().out
    assert resumed["results"] == whole["results"]
    again = torch.load(os.path.join(ckpts, "epoch_002_final", "state.pth"),
                       weights_only=True)["state_dict"]["model"]
    assert all(torch.equal(again[k], v) for k, v in final.items())
    with open(os.path.join(out, "tf_logs", "metrics.jsonl")) as f:
        epochs = [row["step"] for row in map(json.loads, f)
                  if row["tag"] == "time"]
    assert epochs == [1, 2, 2]

    done = run_generalization(out, **kwargs)
    assert "training is complete" in capsys.readouterr().out
    assert done["results"] == whole["results"]


@settings(max_examples=50, deadline=None)
@given(st.lists(st.dictionaries(
    st.sampled_from(["a", "b", "c"]),
    st.floats(0, 100, allow_nan=False), min_size=1), min_size=1, max_size=4),
    st.dictionaries(st.sampled_from(["a", "b", "d"]),
                    st.floats(0, 100, allow_nan=False)))
def test_snapshot_median_is_numpys(snaps, final):
    """Per key of the snapshots: numpy's median over the snapshots that
    hold it and the final value; keys only in the final dict are left
    out."""
    snapshots = {f"{10 * i:03d}": s for i, s in enumerate(snaps)}
    medians = snapshot_medians(final, snapshots)
    keys = set().union(*snaps)
    assert set(medians) == keys
    for key in keys:
        values = [s[key] for s in snaps if key in s]
        values += [final[key]] if key in final else []
        assert medians[key] == float(np.median(values))


def test_a_center_positive_under_the_clamp_gets_no_gradient():
    """One way the overfit fails its rule at 4000 steps, in either dtype
    (F3, ``ROADMAP.md`` section 3): both packages clamp the center
    heatmap to ``[1e-4, 1 - 1e-4]`` after the sigmoid, and a clamp passes
    no gradient outside its range. A positive whose logit falls under
    logit(1e-4) adds ``-(1 - 1e-4)^2 ln(1e-4) / num_pos`` to the focal
    loss and gets no gradient of its own to climb back: with the overfit
    batch's 6 positives that is 1.53475, the last heatmap loss of the
    runs that failed this way (``overfit_breakdown.py``, ``PERF.md``
    section 6)."""
    target = np.zeros((1, 4, 8, 3), np.float32)
    live = [(0, 1, 0), (1, 2, 0), (2, 3, 1), (3, 4, 1), (0, 6, 2)]
    dead = (2, 6, 2)
    logits = np.full(target.shape, -12.0, np.float32)
    for y, x, c in live:
        target[0, y, x, c], logits[0, y, x, c] = 1.0, 12.0
    target[(0, *dead)], logits[(0, *dead)] = 1.0, -12.0
    logits[0, 1, 2, 0] = 0.0          # one live positive at p = 0.5

    x = torch.from_numpy(logits).requires_grad_()
    ours = gaussian_focal_term(
        torch.clamp(torch.sigmoid(x), heads.HEAT_MIN, heads.HEAT_MAX),
        torch.from_numpy(target)).value()
    ours.backward()
    theirs, grad = jax.value_and_grad(lambda v: jax_focal_loss(
        jnp.clip(jax.nn.sigmoid(v), jax_heads.HEAT_MIN, jax_heads.HEAT_MAX),
        jnp.asarray(target)))(jnp.asarray(logits))

    floor = -(1 - 1e-4) ** 2 * np.log(1e-4)
    want = (floor - 0.25 * np.log(0.5)) / 6
    assert float(ours) == pytest.approx(want, rel=1e-5)
    assert float(theirs) == pytest.approx(want, rel=1e-5)
    assert floor / 6 == pytest.approx(1.53475, abs=1e-5)
    for g in (x.grad.numpy(), np.asarray(grad)):
        assert g[(0, *dead)] == 0.0
        assert g[0, 1, 2, 0] < 0       # the live one at 0.5 climbs
