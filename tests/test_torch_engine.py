"""The port's training engine against the JAX engine, step by step over
one epoch whose last batch is short; ``train(resume_from=...)`` against
auto-resume, and its counters against the JAX engine's. (Auto-resume and
checkpoints: ``test_torch_checkpoint.py``.)"""

import json
import math
import os
import shutil
import types

import jax
import numpy as np
import pytest

import monocon_tpu_torch.engine.engine as engine_module
from monocon_tpu.config import get_default_cfg as jax_default_cfg
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu.engine.engine import MonoConEngine as JaxEngine
from monocon_tpu.solver import peek_hyperparams
from monocon_tpu_torch.config import get_default_cfg
from monocon_tpu_torch.engine.engine import MonoConEngine
from monocon_tpu_torch.solver.schedule import WEIGHT_DECAY
from monocon_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_helpers import F32_TOL, assert_same, default_threads  # noqa: F401

IMAGE_HW, CROP_HW = (96, 320), (64, 256)
LOSS_KEYS = 11
GLOBAL_REL, TENSOR_REL = 0.1, 0.25   # gradient and moments against JAX
FLAT_SHARE = 1e-3
FAR_SHARE = 0.1   # measured 0.8%, 3.5% and 6.0% in the three steps


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """5 train and 2 val images: batch 2 leaves a last batch of 1."""
    root = tmp_path_factory.mktemp("kitti_engine")
    jax_generate(str(root), num_train=5, num_val=2, image_hw=IMAGE_HW,
                 max_objects=6, seed=13)
    return root


def make_cfg(tree, out, package="port", **periods):
    cfg = get_default_cfg() if package == "port" else jax_default_cfg()
    cfg.DATA.ROOT = str(tree)
    cfg.DATA.BATCH_SIZE = 2
    cfg.DATA.NUM_WORKERS = 2
    cfg.DATA.CROP_HW = list(CROP_HW)
    cfg.TPU.PAD_HW = list(IMAGE_HW)
    cfg.SOLVER.OPTIM.NUM_EPOCHS = 1
    cfg.PERIOD.EVAL_PERIOD = -1
    cfg.PERIOD.LOG_PERIOD = 1
    cfg.SEED = 0
    cfg.OUTPUT_DIR = str(out)
    for key, value in periods.items():
        cfg.PERIOD[key] = value
    return cfg


# ------------------------------------------------------ against the JAX engine
def _host_copy(state):
    """The JAX train state's variables as numpy copies (the jitted step
    donates its input buffers)."""
    return jax.tree.map(lambda x: np.array(x, copy=True),
                        {"params": state.params,
                         "batch_stats": state.batch_stats})


def _adam_moments(state):
    """Numpy copies of ``(mu, nu)``, the ``scale_by_adam`` state inside the
    train state's optax chain, each as a variables tree."""
    for leaf in jax.tree.leaves(state.opt_state,
                                is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return tuple(jax.tree.map(lambda x: np.array(x, copy=True),
                                      {"params": moment,
                                       "batch_stats": state.batch_stats})
                         for moment in (leaf.mu, leaf.nu))
    raise AssertionError("no scale_by_adam state")


@pytest.fixture(scope="module")
def jax_run(tree, tmp_path_factory):
    """One epoch of the JAX engine on the CPU: per step the variables it
    started from, the 11 losses, the LR read after the step, the batch's
    rows, whether padding rows were masked out and Adam's two moments after
    the step; and the variables after the last step."""
    cfg = make_cfg(tree, tmp_path_factory.mktemp("jax_out"), "jax")
    cfg.TPU.NUM_DEVICES = 1
    engine = JaxEngine(cfg)
    steps = []
    step_fn = engine._train_step

    def recording(state, batch):
        before = _host_copy(state)
        state, losses = step_fn(state, batch)
        steps.append(({k: float(v) for k, v in losses.items()},
                      float(peek_hyperparams(state.opt_state)["learning_rate"]),
                      int(batch["img"].shape[0]), "valid" in batch, before,
                      _adam_moments(state), np.array(batch["img"], copy=True)))
        return state, losses

    engine._train_step = recording
    mean = engine.train_one_epoch()
    return steps, _host_copy(engine.state), mean, engine.global_iters


def _relative_errors(ours, theirs):
    """``(global, per tensor)`` relative L2 errors of the ``ours`` tensors
    against ``theirs`` (dicts by parameter name). Tensors whose own norm is
    under ``FLAT_SHARE`` of the median tensor's are left out of the per
    tensor errors: conv biases ahead of a BN, whose gradient is float32
    noise around 0."""
    num = den = 0.0
    norms = {k: float(v.double().norm()) for k, v in theirs.items()}
    flat = FLAT_SHARE * float(np.median(list(norms.values())))
    per_tensor = {}
    for key, want in theirs.items():
        err = float((ours[key].double() - want.double()).norm())
        num, den = num + err ** 2, den + norms[key] ** 2
        if norms[key] >= flat:
            per_tensor[key] = err / norms[key]
    return (num / den) ** 0.5, per_tensor


@pytest.mark.usefixtures("default_threads")
def test_engine_matches_jax_step_by_step(jax_run, tree, tmp_path,
                                         monkeypatch):
    """The same tree, seed and augmentation through both engines' epoch.
    Before each of its steps the port's detector takes the JAX engine's
    variables of that step: in float32 an Adam step moves every weight by
    about the LR whatever its gradient, so where a gradient is at float32
    noise the two packages step opposite ways, and the trajectories part
    (a relative 1e-7 on the port's own initial weights moves step 2's
    losses by up to 4.6% on the CPU). The optimizer keeps its own state.
    Then after each step:

    * the 11 losses agree within rtol 1e-3 / atol 1e-4, and so do the BN
      running stats;
    * the step's clipped gradient, and AdamW's two moments carried over
      the epoch, agree with JAX's (its gradient is read from its first
      moments, ``(mu_t - b1 mu_t-1) / (1 - b1)``) within a relative L2
      error of ``GLOBAL_REL`` over all parameters and ``TENSOR_REL`` per
      tensor. Not per element: at these random weights float32 alone
      moves the gradient by a relative 1.1e-2 to 3.4e-2 (the port in
      float32 against itself in float64, same weights and batch, on the
      CPU), up to 8% in single tensors; a zero, sign-flipped or halved
      gradient or a moment not carried over is off by 0.25 or more;
    * every weight is AdamW's closed form of the port's own moments
      (float32 rounding: rtol 1e-6, atol 1e-3 LR), within 4 LR of JAX's
      (an Adam step moves a weight by at most 1.75 LR in the first three
      steps), and at most ``FAR_SHARE`` of the weights lie more than 0.1
      LR from JAX's;
    * the LR sequence (JAX evaluates the schedule in float32: rtol 1e-6),
      the step count and the counters are equal.

    The JAX engine pads the last batch to 2 and masks the copy out; the
    port feeds one real row."""
    jax_steps, jax_final, jax_mean, jax_iters = jax_run
    engine = MonoConEngine(make_cfg(tree, tmp_path), device="cpu")
    afters = [s[4] for s in jax_steps[1:]] + [jax_final]
    steps = []
    real_step = engine_module.train_step

    def recording(model, optimizer, scheduler, batch, layout):
        assert layout is None      # one process, no bands
        i = len(steps)
        before = state_dict_from_jax(jax_steps[i][4])
        model.load_state_dict(before)
        losses = real_step(model, optimizer, scheduler, batch, layout)
        steps.append(({k: float(v) for k, v in losses.items()},
                      engine.current_lr, int(batch["img"].shape[0])))
        want = state_dict_from_jax(afters[i])
        got = model.state_dict()
        for key, value in want.items():
            if "running_" in key:
                np.testing.assert_allclose(got[key], value, **F32_TOL,
                                           err_msg=f"step {i} {key}")

        group = optimizer.param_groups[0]
        lr, (beta1, beta2), eps = group["lr"], group["betas"], group["eps"]
        params = dict(model.named_parameters())
        mu, nu = ({k: v for k, v in state_dict_from_jax(m).items()
                   if k in params} for m in jax_steps[i][5])
        mu_prev = ({k: 0 * v for k, v in mu.items()} if i == 0 else
                   state_dict_from_jax(jax_steps[i - 1][5][0]))
        jax_grad = {k: (v.double() - beta1 * mu_prev[k].double()) / (1 - beta1)
                    for k, v in mu.items()}
        for what, ours, theirs in (
                ("gradient", {k: p.grad for k, p in params.items()},
                 jax_grad),
                ("exp_avg", {k: optimizer.state[p]["exp_avg"]
                             for k, p in params.items()}, mu),
                ("exp_avg_sq", {k: optimizer.state[p]["exp_avg_sq"]
                                for k, p in params.items()}, nu)):
            total_err, per_tensor = _relative_errors(ours, theirs)
            name, worst = max(per_tensor.items(), key=lambda kv: kv[1])
            print(f"step {i} {what}: relative L2 {total_err:.3e}, worst "
                  f"tensor {worst:.3e} ({name})")
            assert total_err <= GLOBAL_REL, f"step {i} {what}"
            assert worst <= TENSOR_REL, f"step {i} {what} {name}"

        far = total = 0
        for name, param in params.items():
            state = optimizer.state[param]
            t = float(state["step"])
            m, v = state["exp_avg"].double(), state["exp_avg_sq"].double()
            closed = (before[name].double() * (1 - lr * WEIGHT_DECAY)
                      - lr / (1 - beta1 ** t) * m
                      / (v.sqrt() / math.sqrt(1 - beta2 ** t) + eps))
            np.testing.assert_allclose(param.detach().double(), closed,
                                       rtol=1e-6, atol=1e-3 * lr,
                                       err_msg=f"step {i} {name}")
            diff = (got[name] - want[name]).abs()
            assert float(diff.max()) <= 4 * lr, f"step {i} {name}"
            far += int((diff > 0.1 * lr).sum())
            total += diff.numel()
        print(f"step {i}: {far} of {total} weights more than 0.1 LR from "
              "JAX's")
        assert far <= FAR_SHARE * total, f"step {i}"
        return losses

    monkeypatch.setattr(engine_module, "train_step", recording)
    mean = engine.train_one_epoch()

    assert [s[2] for s in steps] == [2, 2, 1]
    assert [(s[2], s[3]) for s in jax_steps] == [(2, False), (2, False),
                                                 (2, True)]
    assert engine.global_iters == jax_iters == 4
    for i, ((got, lr, _), (want, jax_lr, *_)) in enumerate(
            zip(steps, jax_steps, strict=True)):
        assert set(got) == set(want) and len(got) == LOSS_KEYS
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, **F32_TOL,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(lr, jax_lr, rtol=1e-6, err_msg=f"step {i}")
    np.testing.assert_allclose(mean, jax_mean, **F32_TOL)
    assert all(isinstance(v, float) for v in engine.entire_losses)


# ------------------------------------------------------------- resume_from
class _FirstBatch:
    """A train loader cut after its first batch: a run stopped right after
    the checkpoint of step 1."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        yield next(iter(self.loader))


@pytest.fixture(scope="module")
def resume_points(tree, tmp_path_factory):
    """Two checkpoints of one run, copied aside: ``mid``, taken after step
    1 of epoch 1 (of 3), and ``end``, the final one of epoch 1."""
    out = tmp_path_factory.mktemp("resume_source")
    keep = tmp_path_factory.mktemp("resume_points")
    engine = MonoConEngine(make_cfg(tree, out, CKPT_PERIOD_STEPS=1),
                           device="cpu")
    engine.train_loader = _FirstBatch(engine.train_loader)
    engine.train_one_epoch()
    points = {"mid": shutil.copytree(out / "checkpoints" / "epoch_001",
                                     keep / "mid" / "epoch_001")}
    MonoConEngine(make_cfg(tree, out, CKPT_PERIOD_STEPS=1),
                  device="cpu").train()
    points["end"] = shutil.copytree(out / "checkpoints" / "epoch_001_final",
                                    keep / "end" / "epoch_001_final")
    return points


@pytest.mark.parametrize("point", ["mid", "end", "end_over_mid"])
def test_train_resume_from_equals_auto_resume(point, resume_points, tree,
                                              tmp_path):
    """``train(resume_from=...)`` into a fresh OUTPUT_DIR, with another
    SEED, against auto-resume from a copy of the same checkpoint: the same
    counters, data seed, loss history (the next steps' losses included),
    weights, BN state and AdamW state, bit for bit on the CPU. The ``end``
    checkpoint is named by its ``state.pth``, ``mid`` by its directory;
    ``end_over_mid`` names ``end`` to an engine that auto-resumed ``mid``
    (the mid-epoch step count must not survive into the next epoch)."""
    source = resume_points[point.split("_")[0]]
    epochs = 1 if point == "mid" else 2
    if point == "end_over_mid":
        shutil.copytree(resume_points["mid"],
                        tmp_path / "named" / "checkpoints" / "epoch_001")
    cfg = make_cfg(tree, tmp_path / "named")
    cfg.SOLVER.OPTIM.NUM_EPOCHS = epochs
    cfg.SEED = 123
    named = MonoConEngine(cfg, device="cpu")
    named.train(resume_from=str(source / "state.pth" if point != "mid"
                                else source))
    shutil.copytree(source, tmp_path / "auto" / "checkpoints" / source.name)
    cfg = make_cfg(tree, tmp_path / "auto")
    cfg.SOLVER.OPTIM.NUM_EPOCHS = epochs
    auto = MonoConEngine(cfg, device="cpu")
    auto.train()
    assert (named.epochs, named.global_iters, named.cfg.SEED) == (
        auto.epochs, auto.global_iters, auto.cfg.SEED) == (
        epochs, 3 * epochs + 1, 0)
    assert named.entire_losses == auto.entire_losses
    assert len(auto.entire_losses) == 3 * epochs
    assert_same(named.model.state_dict(), auto.model.state_dict())
    assert_same(named.optimizer.state_dict(), auto.optimizer.state_dict())
    assert named.solver.count == auto.solver.count == 3 * epochs
    assert os.path.isfile(tmp_path / "named" / "config.yaml")


@pytest.mark.parametrize("point", ["mid", "end"])
def test_resume_counters_equal_jax(point, resume_points, tree, tmp_path,
                                   monkeypatch):
    """The epoch, step-in-epoch, iteration and data-seed arithmetic of a
    resume, the port's against the JAX engine's ``load_checkpoint`` given
    the same ``meta.json`` (its Orbax restore stubbed out)."""
    import monocon_tpu.engine.engine as jax_engine_module

    source = resume_points[point]
    with open(source / "meta.json") as f:
        meta = json.load(f)
    monkeypatch.setattr(jax_engine_module, "load_checkpoint",
                        lambda path, state: (state, meta))
    monkeypatch.setattr(jax_engine_module, "replicate_state",
                        lambda state, mesh: state)
    jax_cfg = jax_default_cfg()
    jax_cfg.SEED = 123
    fake = types.SimpleNamespace(
        is_test=False, state=None, mesh=None, cfg=jax_cfg,
        train_loader=None, test_loader=None, epochs=1, global_iters=1,
        _resume_step_in_epoch=0)
    JaxEngine.load_checkpoint(fake, str(source))
    cfg = make_cfg(tree, tmp_path)
    cfg.SEED = 123
    engine = MonoConEngine(cfg, device="cpu")
    engine.load_checkpoint(str(source))
    assert (engine.epochs, engine._resume_step_in_epoch, engine.global_iters,
            engine.cfg.SEED, engine.entire_losses) == (
        fake.epochs, fake._resume_step_in_epoch, fake.global_iters,
        fake.cfg.SEED, fake.entire_losses)
    assert (engine.epochs, engine._resume_step_in_epoch) == (
        (1, 1) if point == "mid" else (2, 0))
