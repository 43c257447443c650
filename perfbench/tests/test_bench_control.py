"""The controls: the reference put in the program's place, computed in
the precision below the configuration's (TF32) or with a fault planted
(``check.FAULTS``), which the check must read as not correct. The planted
faults on the CPU at a small size; the TF32 control, which the CPU does
not compute, on the card at the cells' own size (``cuda``; the readings
in PERF.md come from ``perfbench/calibrate.py``, which runs the same)."""

import pytest
import torch

from perfbench import check, run
from perfbench.drivers import KINDS
from perfbench.tests.tiny import tiny_spec


def readings(spec, seed, device, control, cache=None):
    traffic = spec["traffic"]
    cell = KINDS[traffic["kind"]]("control", spec["config"], traffic, seed,
                                  device, **({} if cache is None else
                                             {"cache": cache}))
    cell.setup()
    record = cell.record
    cell.free()
    return check.train_check(record, spec["config"], traffic["augment"],
                             device, control)


def failed(numbers, limits, prefix):
    return [k for k, limit in limits.items()
            if numbers.get(prefix + k, 0.0) > limit]


@pytest.mark.parametrize("workload", ["dla34-f32.train-step",
                                      "dla102-f32.train-step"])
def test_planted_faults_are_not_correct_at_a_small_size(workload, tmp_path):
    spec = tiny_spec(workload)
    limits = spec["config"]["limits"]
    numbers = readings(spec, 5, torch.device("cpu"), ",".join(check.FAULTS),
                       tmp_path)
    assert not failed(numbers, limits, ""), numbers
    for fault in check.FAULTS:
        assert failed(numbers, limits, f"{fault}_"), (fault, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dla34-f32.train-step",
                                      "dla102-f32.train-step"])
def test_control_is_not_correct_on_the_card(workload, card):
    spec = run.cell_spec(workload)
    run.program_backends(spec["config"])
    control = spec["config"]["control"]
    limits = spec["config"]["limits"]
    for seed in (1, 2, 3):
        numbers = readings(spec, seed, card,
                           ",".join([control, *check.FAULTS]))
        for name in (control, *check.FAULTS):
            assert failed(numbers, limits, f"{name}_"), (name, numbers)
        assert not failed(numbers, limits, ""), numbers
