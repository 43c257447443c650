"""Gradient accumulation in the port's engine against the JAX engine: an
epoch of 5 batches at ``TPU.GRAD_ACCUM_STEPS = 2``, with a short last
batch and an accumulation left open at the end of the epoch. (A resume
between two micro-steps: ``test_torch_accum_resume.py``.)"""

import jax
import numpy as np
import pytest
import torch

import monocon_tpu.engine.engine as jax_engine_module
import monocon_tpu_torch.engine.engine as engine_module
from monocon_tpu.config import get_default_cfg as jax_default_cfg
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu.engine.engine import MonoConEngine as JaxEngine
from monocon_tpu.models.detector import MonoConDetector as JaxDetector
from monocon_tpu.parallel.mesh import batch_sharding
from monocon_tpu.solver import peek_hyperparams
from monocon_tpu.utils.torch_convert import convert_state_dict
from monocon_tpu_torch.config import get_default_cfg
from monocon_tpu_torch.engine.engine import MonoConEngine
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_engine import _host_copy
from torch_port_helpers import F32_TOL

IMAGE_HW, CROP_HW = (64, 160), (48, 128)
ACCUM = 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """9 train images: batch 2 gives 5 batches, the last of one image."""
    root = tmp_path_factory.mktemp("kitti_accum")
    jax_generate(str(root), num_train=9, num_val=1, image_hw=IMAGE_HW,
                 max_objects=6, seed=23)
    return root


def make_cfg(tree, out, package="port", **periods):
    cfg = get_default_cfg() if package == "port" else jax_default_cfg()
    cfg.DATA.ROOT, cfg.OUTPUT_DIR, cfg.SEED = str(tree), str(out), 0
    cfg.DATA.BATCH_SIZE, cfg.DATA.NUM_WORKERS = 2, 2
    cfg.DATA.CROP_HW, cfg.TPU.PAD_HW = list(CROP_HW), list(IMAGE_HW)
    cfg.TPU.GRAD_ACCUM_STEPS = ACCUM
    cfg.SOLVER.OPTIM.NUM_EPOCHS = 1
    cfg.PERIOD.EVAL_PERIOD, cfg.PERIOD.LOG_PERIOD = -1, 1
    for key, value in periods.items():
        cfg.PERIOD[key] = value
    return cfg


def _detector_state(rng, num_layers, num_classes, image_hw, dtype):
    """The JAX engine's initial variables, from a detector of the port's
    init through the JAX package's ``.pth`` importer: quicker here than
    compiling the JAX init, and any weights serve the comparison."""
    model = create_detector(num_layers, num_classes,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return JaxDetector(num_layers, num_classes, dtype=dtype), \
        convert_state_dict({k: v.numpy()
                            for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def jax_run(tree, tmp_path_factory):
    """One epoch of the JAX engine: per micro-step the variables it started
    from and ended with, the 11 losses, the LR and ``MultiSteps``'
    counters after it, and the batch's rows."""
    cfg = make_cfg(tree, tmp_path_factory.mktemp("jax_out"), "jax")
    cfg.TPU.NUM_DEVICES = 1
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_engine_module, "create_detector_state",
                      _detector_state)
        engine = JaxEngine(cfg)
    steps = []
    step_fn = engine._train_step

    def recording(state, batch):
        before = _host_copy(state)
        masked = "valid" in batch
        if not masked:
            # The full batches through the masked program too, with every
            # row valid (the same moments and losses): one compile here
            # instead of two.
            batch = {**batch, "valid": jax.device_put(
                np.ones(batch["img"].shape[0], np.float32),
                batch_sharding(engine.mesh))}
        state, losses = step_fn(state, batch)
        opt_state = state.opt_state
        steps.append(dict(
            losses={k: float(v) for k, v in losses.items()}, before=before,
            after=_host_copy(state),
            lr=float(peek_hyperparams(opt_state)["learning_rate"]),
            counters=(int(opt_state.gradient_step), int(opt_state.mini_step)),
            rows=int(batch["img"].shape[0]), masked=masked))
        return state, losses

    engine._train_step = recording
    mean = engine.train_one_epoch()
    return steps, mean, engine.global_iters


def test_engine_accumulates_as_jax(jax_run, tree, tmp_path, monkeypatch):
    """The same tree, seed and augmentation through both engines' epoch of
    5 micro-steps. Before each micro-step the port's detector takes the JAX
    engine's variables of that step (float32 trajectories part through
    Adam: ``test_torch_engine.py``); the solver keeps its own accumulation.
    After each micro-step the 11 losses and the BN running stats agree
    within rtol 1e-3 / atol 1e-4, the LR (that of the last optimizer step)
    within rtol 1e-6, and the optimizer step count and micro-step index
    equal ``MultiSteps``': steps after micro-steps 2 and 4, and micro-step
    5, the short last batch, left open at the end of the epoch. The
    weights move only on those two steps."""
    jax_steps, jax_mean, jax_iters = jax_run
    engine = MonoConEngine(make_cfg(tree, tmp_path), device="cpu")
    assert engine.solver.total_steps == 5 // ACCUM
    ours = []
    real_step = engine_module.train_step

    def recording(model, optimizer, solver, batch, layout):
        assert layout is None      # one process, no bands
        step = jax_steps[len(ours)]
        before = state_dict_from_jax(step["before"])
        model.load_state_dict(before)
        losses = real_step(model, optimizer, solver, batch, layout)
        got, want = model.state_dict(), state_dict_from_jax(step["after"])
        for key, value in want.items():
            if "running_" in key:
                np.testing.assert_allclose(got[key], value, **F32_TOL,
                                           err_msg=f"step {len(ours)} {key}")
        moved = any(not np.array_equal(got[k], before[k])
                    for k, _ in model.named_parameters())
        ours.append(dict(losses={k: float(v) for k, v in losses.items()},
                         lr=engine.current_lr, moved=moved,
                         counters=(solver.count, solver.mini_step),
                         rows=int(batch["img"].shape[0])))
        return losses

    monkeypatch.setattr(engine_module, "train_step", recording)
    mean = engine.train_one_epoch()

    assert [s["rows"] for s in ours] == [2, 2, 2, 2, 1]
    assert [(s["rows"], s["masked"]) for s in jax_steps] == [
        (2, False)] * 4 + [(2, True)]
    assert engine.global_iters == jax_iters == 6
    assert [s["moved"] for s in ours] == [False, True, False, True, False]
    for i, (got, want) in enumerate(zip(ours, jax_steps, strict=True)):
        assert got["counters"] == want["counters"], f"step {i}"
        assert set(got["losses"]) == set(want["losses"])
        for key, value in want["losses"].items():
            np.testing.assert_allclose(got["losses"][key], value, **F32_TOL,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6,
                                   err_msg=f"step {i}")
    assert ours[-1]["counters"] == (2, 1)
    np.testing.assert_allclose(mean, jax_mean, **F32_TOL)
