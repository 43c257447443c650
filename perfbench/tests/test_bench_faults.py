"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped, a cell driven at a small size on
the CPU, once sound and once for each fault a training cell can have on
one chip (a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; a pixel of a batch altered where
the loader produces it), and for a residual block's middle convolution
computed with its kernel mirrored. Four chips' exchange is not a fault a
one-chip cell can have."""


import pytest
import torch

from perfbench import run
from perfbench.tests.tiny import tiny_spec



@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


def drive(workload, cache):
    """One run at the small size, held to the configuration's limits."""
    spec = tiny_spec(workload)
    result, numbers = run.run_cell(spec, 1234567890123, 1.0, False,
                                   torch.device("cpu"), cache=cache)
    return result, numbers


def unchanged_state(monkeypatch):
    from monocon_tpu_torch.solver import schedule

    monkeypatch.setattr(schedule.Solver, "step", lambda self: False)
    return "update_gap"


def half_batch(monkeypatch):
    from monocon_tpu_torch.engine import engine, train_step

    inner = train_step.train_step

    def halved(model, optimizer, solver, batch, layout=None):
        def cut(tree):
            if isinstance(tree, dict):
                return {k: cut(v) for k, v in tree.items()}
            return tree[:len(tree) // 2]
        return inner(model, optimizer, solver, cut(batch), layout)

    monkeypatch.setattr(train_step, "train_step", halved)
    monkeypatch.setattr(engine, "train_step", halved)
    return "loss_gap1"


def altered_pixel(monkeypatch):
    from monocon_tpu_torch.data import loader

    inner = loader.collate

    def collate(*args, **kwargs):
        batch = inner(*args, **kwargs)
        batch["img"][0, 10, 10, 0] ^= 1
        return batch

    monkeypatch.setattr(loader, "collate", collate)
    return "batch_diff"


def mirrored_conv2(monkeypatch):
    """The program's ``backbone.level5.tree2.conv2`` computes with its
    kernel rotated by 180 degrees (the reference's ``conv2`` fault)."""
    import torch.nn.functional as F

    from perfbench.drivers import TrainStep

    inner = TrainStep._load_weights

    def load(self):
        inner(self)
        conv = self.engine.model.backbone.level5.tree2.conv2
        conv.forward = lambda x: F.conv2d(
            x, conv.weight.flip(-2, -1), conv.bias, conv.stride,
            conv.padding, conv.dilation, conv.groups)

    monkeypatch.setattr(TrainStep, "_load_weights", load)
    return "loss_gap1"


@pytest.mark.parametrize("workload", ["dla34-f32.train-step",
                                      "dla102-f32.train-step"])
def test_sound_run_is_correct(workload, cache):
    result, numbers = drive(workload, cache)
    assert result["correct"], result["checks"]


# At the small size DLA-102's deepest block sees a 3x10 map, where the
# mirrored kernel moves the first loss by about the limit; the card's
# readings at the cell's size hold it (PERF.md), and the CPU test of the
# reference's planted fault (test_bench_control.py) reads it here.
CASES = ([("dla34-f32.train-step", f) for f in
          (unchanged_state, half_batch, altered_pixel, mirrored_conv2)]
         + [("dla102-f32.train-step", f) for f in
            (unchanged_state, half_batch, altered_pixel)])


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_reads_not_correct(workload, fault, cache, monkeypatch):
    number = fault(monkeypatch)
    result, numbers = drive(workload, cache)
    assert not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"], result["checks"]
