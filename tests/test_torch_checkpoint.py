"""The port's checkpoints: mid-epoch resume bit for bit on the CPU, the
commit marker, auto-resume of a finished run, and ``state.pth`` read by the
port's loaders, its test CLI and the JAX package; the ImageNet backbone
import and the config export."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import monocon_tpu_torch.engine.checkpoint as checkpoint_module
from monocon_tpu.data.synthetic import generate_kitti_dataset as jax_generate
from monocon_tpu.models import create_detector_state
from monocon_tpu.utils.torch_convert import (
    load_imagenet_backbone as jax_load_imagenet_backbone,
)
from monocon_tpu.utils.torch_convert import load_torch_checkpoint
from monocon_tpu_torch.config import export_cfg, get_default_cfg
from monocon_tpu_torch.engine.checkpoint import (latest_checkpoint,
                                                 load_checkpoint,
                                                 load_imagenet_backbone,
                                                 load_weights, save_checkpoint)
from monocon_tpu_torch.engine.engine import MonoConEngine
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.solver.schedule import build_optimizer
from monocon_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_engine import IMAGE_HW, make_cfg
from torch_port_helpers import assert_same, perturb_variables

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """5 train and 2 val images: batch 2 leaves a last batch of 1."""
    root = tmp_path_factory.mktemp("kitti_resume")
    jax_generate(str(root), num_train=5, num_val=2, image_hw=IMAGE_HW,
                 max_objects=6, seed=17)
    return root


class FirstN:
    """A loader that yields only the first ``n`` batches of each epoch: a
    run cut short mid-epoch."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        for _ in range(self.n):
            yield next(it)


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """A: one epoch, uninterrupted, a checkpoint every step. B: the same,
    cut after step 1. C: a fresh engine with another SEED, auto-resumed
    from B's directory, trained to the end. Returns A, C, what C resumed
    at, and A's output directory."""
    out_a = tmp_path_factory.mktemp("run_a")
    engine_a = MonoConEngine(make_cfg(tree, out_a, CKPT_PERIOD_STEPS=1),
                             device="cpu")
    engine_a.train()
    out_b = tmp_path_factory.mktemp("run_b")
    engine_b = MonoConEngine(make_cfg(tree, out_b, CKPT_PERIOD_STEPS=1),
                             device="cpu")
    engine_b.train_loader = FirstN(engine_b.train_loader, 1)
    engine_b.train_one_epoch()
    cfg_c = make_cfg(tree, out_b, CKPT_PERIOD_STEPS=1)
    cfg_c.SEED = 12345
    engine_c = MonoConEngine(cfg_c, device="cpu")
    resumed = dict(epochs=engine_c.epochs,
                   step_in_epoch=engine_c._resume_step_in_epoch,
                   seed=engine_c.cfg.SEED,
                   loader_seeds=(engine_c.train_loader.seed,
                                 engine_c.test_loader.seed))
    engine_c.train()
    return engine_a, engine_c, resumed, out_a


def _final_state(out):
    return os.path.join(out, "checkpoints", "epoch_001_final", "state.pth")


def test_midepoch_resume_is_bit_identical(runs):
    """C re-enters epoch 1 after its step 1 with A's data seed, and ends
    where A ends: the same counters and loss history, bit-identical
    weights, BN state, AdamW state and schedule."""
    engine_a, engine_c, resumed, _ = runs
    assert resumed == dict(epochs=1, step_in_epoch=1, seed=0,
                           loader_seeds=(0, 0))
    assert engine_c.global_iters == engine_a.global_iters == 4
    assert len(engine_a.entire_losses) == 3
    assert engine_c.entire_losses == engine_a.entire_losses
    assert all(isinstance(v, float) for v in engine_c.entire_losses)
    assert_same(engine_c.model.state_dict(), engine_a.model.state_dict())
    assert_same(engine_c.optimizer.state_dict(),
                engine_a.optimizer.state_dict())
    assert engine_c.solver.count == engine_a.solver.count == 3
    assert engine_c.current_lr == engine_a.current_lr > 0


def test_checkpoint_files_hold_the_run(runs):
    """The final checkpoint's ``state.pth`` is the reference engine
    container and ``meta.json`` the run's counters, history and seed;
    ``config.yaml`` and the metrics file are written."""
    engine_a, _, _, out_a = runs
    container = torch.load(_final_state(out_a), weights_only=True)
    assert set(container) == {"engine_attrs", "state_dict"}
    assert set(container["state_dict"]) == {"model", "optimizer",
                                            "scheduler"}
    assert container["state_dict"]["scheduler"] == {"count": 3}
    assert container["engine_attrs"] == {"epochs": 1, "global_iters": 4}
    with open(os.path.join(os.path.dirname(_final_state(out_a)),
                           "meta.json")) as f:
        meta = json.load(f)
    assert meta["entire_losses"] == engine_a.entire_losses
    assert (meta["epoch"], meta["global_iters"], meta["step_in_epoch"],
            meta["seed"]) == (1, 4, 0, 0)
    with open(os.path.join(out_a, "config.yaml")) as f:
        assert yaml.safe_load(f) == engine_a.cfg.to_plain_dict()
    with open(os.path.join(out_a, "tf_logs", "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [x["step"] for x in lines if x["tag"] == "loss"] == [1, 2, 3]
    assert len(lines[0]) == 2 + 10


def test_finished_run_resumes_at_the_next_epoch(runs):
    engine_a, _, _, out_a = runs
    cfg = engine_a.cfg.clone()
    cfg.SOLVER.OPTIM.NUM_EPOCHS = 2
    engine = MonoConEngine(cfg, device="cpu")
    assert engine.epochs == 2 and engine._resume_step_in_epoch == 0
    assert engine.global_iters == engine_a.global_iters
    assert engine.entire_losses == engine_a.entire_losses
    assert engine.epoch_times == pytest.approx(engine_a.epoch_times)
    assert engine.solver.count == 3
    assert_same(engine.model.state_dict(), engine_a.model.state_dict())


def test_partial_checkpoint_is_skipped(tmp_path, monkeypatch):
    """``meta.json`` is written last: a directory without it (a save cut
    short) is never resumed, also where the cut save overwrote a complete
    checkpoint of the same name (the periodic saves of one epoch)."""
    model = torch.nn.Linear(3, 2)
    opt, sched = build_optimizer(model.parameters(), total_steps=4)
    wd = str(tmp_path / "ckpts")
    p1 = save_checkpoint(wd, model, opt, sched, epoch=1, global_iters=10)
    sched.step()
    p2 = save_checkpoint(wd, model, opt, sched, epoch=2, global_iters=20)
    assert latest_checkpoint(wd) == p2
    assert sorted(os.listdir(p2)) == ["meta.json", "state.pth"]
    meta = load_checkpoint(p2, model, opt, sched)
    assert (meta["epoch"], meta["global_iters"], sched.count) == (2, 20, 1)

    # A second save into p2, cut after its state.pth is in place.
    real_replace = checkpoint_module._replace_atomically

    def cut_before_marker(path, write):
        if path.endswith("meta.json"):
            raise KeyboardInterrupt("cut")
        real_replace(path, write)

    monkeypatch.setattr(checkpoint_module, "_replace_atomically",
                        cut_before_marker)
    sched.step()
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(wd, model, opt, sched, epoch=2, global_iters=30)
    monkeypatch.undo()
    assert os.listdir(p2) == ["state.pth"]
    assert latest_checkpoint(wd) == p1
    p2 = save_checkpoint(wd, model, opt, sched, epoch=2, global_iters=30)
    assert latest_checkpoint(wd) == p2
    assert load_checkpoint(p2, model, opt, sched)["global_iters"] == 30
    assert sched.count == 2
    os.remove(os.path.join(p2, "meta.json"))
    assert latest_checkpoint(wd) == p1
    os.remove(os.path.join(p1, "meta.json"))
    assert latest_checkpoint(wd) is None


def test_epoch_boundary_resume_does_not_replay(tree, tmp_path):
    """A checkpoint on the epoch's last step: the epoch returns its
    restored mean without loading a batch."""
    engine = MonoConEngine(make_cfg(tree, tmp_path), device="cpu")
    steps = len(engine.train_loader)

    class Boom:
        def __len__(self):
            return steps

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            raise AssertionError("completed epoch was replayed")

    engine.entire_losses = [2.0] * steps
    engine._resume_step_in_epoch = steps
    engine.train_loader = Boom()
    assert engine.train_one_epoch() == pytest.approx(2.0)


# ------------------------------------------------------- reading state.pth
def test_state_pth_loads_as_a_pth(runs, tmp_path):
    """``load_weights``, an evaluation engine given the file or its
    directory, and the JAX package's ``load_torch_checkpoint`` read the
    run's weights."""
    engine_a, _, _, out_a = runs
    want = engine_a.model.state_dict()
    model = create_detector(device="cpu")
    load_weights(_final_state(out_a), model)
    assert_same(model.state_dict(), want)
    for path in (_final_state(out_a), os.path.dirname(_final_state(out_a))):
        cfg = engine_a.cfg.clone()
        cfg.OUTPUT_DIR = str(tmp_path)
        engine = MonoConEngine(cfg, is_test=True, device="cpu")
        engine.load_checkpoint(path)
        assert_same(engine.model.state_dict(), want)
    jax_sd = state_dict_from_jax(load_torch_checkpoint(_final_state(out_a)))
    assert jax_sd.keys() == want.keys()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(jax_sd[key], value), key


def test_test_cli_evaluates_a_state_pth(runs, tree):
    _, _, _, out_a = runs
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.test", "--checkpoint_file",
         _final_state(out_a), "--data_root", str(tree), "--evaluate",
         "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "loaded" in proc.stdout and "3d   AP40" in proc.stdout


def test_imagenet_backbone_matches_jax(tmp_path):
    """A DLA-34 ImageNet-format ``.pth`` (no ``backbone.`` prefix, an
    ``fc`` head, ``num_batches_tracked``): the port's backbone gets the
    weights JAX's ``load_imagenet_backbone`` converts, and keeps its own
    ``num_batches_tracked``."""
    _, variables = create_detector_state(jax.random.PRNGKey(1),
                                         image_hw=(64, 96))
    variables = perturb_variables(variables, np.random.default_rng(1))
    full = state_dict_from_jax(variables)
    imagenet = {k[len("backbone."):]: v for k, v in full.items()
                if k.startswith("backbone.")}
    for k in imagenet:
        if k.endswith("num_batches_tracked"):
            imagenet[k] = torch.tensor(7)
    imagenet["fc.weight"] = torch.ones(1000, 512, 1, 1)
    imagenet["fc.bias"] = torch.zeros(1000)
    path = tmp_path / "dla34-imagenet.pth"
    torch.save(imagenet, path)

    model = create_detector(device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_imagenet_backbone(str(path), model)
    jax_bb = jax_load_imagenet_backbone(str(path))
    variables["params"]["backbone"] = jax_bb["params"]["backbone"]
    variables["batch_stats"]["backbone"] = jax_bb["batch_stats"]["backbone"]
    want = state_dict_from_jax(variables)
    got = model.state_dict()
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(value, before[key]), key
        elif key.startswith("backbone."):
            assert torch.equal(value, want[key]), key
        else:
            assert torch.equal(value, before[key]), key

    del imagenet["base_layer.0.weight"]
    torch.save(imagenet, path)
    with pytest.raises(RuntimeError, match="base_layer.0.weight"):
        load_imagenet_backbone(str(path), model)


def test_export_cfg_reads_back_with_yaml(tmp_path):
    """``export_cfg`` writes YAML without PyYAML; ``yaml.safe_load`` reads
    back the same tree, floats, lists, None and odd strings included."""
    cfg = get_default_cfg()
    cfg.SOLVER.OPTIM.WEIGHT_DECAY = 1e-5
    cfg.OUTPUT_DIR = 'a "quoted": path\\with #hash\n'
    cfg.TPU.PAD_HW = None
    cfg.EXTRA = {"on": [1.5, -2, 3e-8, True, "yes"], "empty": {}, "n": None,
                 "inf": float("inf")}
    path = tmp_path / "config.yaml"
    export_cfg(cfg, str(path))
    text = path.read_text()
    assert "WEIGHT_DECAY: 1.0e-05" in text
    assert yaml.safe_load(text) == cfg.to_plain_dict()
    export_cfg(get_default_cfg(), str(path))
    assert yaml.safe_load(path.read_text()) == get_default_cfg().to_plain_dict()
