"""The detector's memory format: contiguous NCHW for float32 on a CUDA
device whose convolutions cuDNN autotunes, channels_last everywhere else
(``models/detector.py``), with the train CLI's ``configure_backends``
saying whether cuDNN autotunes.

On the CPU a DLA-34 detector switched to contiguous NCHW takes one train
step beside the channels_last one from the same weights: the same losses
and gradients, and contiguous NHWC float32 predictions from both. The
step runs in float64: in float32 the two formats take oneDNN algorithms
that round differently, by as much as 1% of the first convolution's
gradient on two threads, while in float64 they agree to 1e-11 of each
leaf's largest element on 1, 2 or 8 threads."""

import copy

import numpy as np
import pytest
import torch

from monocon_tpu_torch.engine.train_step import train_step
from monocon_tpu_torch.models.detector import (conv_memory_format,
                                               create_detector)
from monocon_tpu_torch.solver.schedule import build_optimizer
from tests.test_ops_parity import random_label_batch

HW, BATCH = (64, 96), 2
RTOL = 1e-5
# Absolute tolerance of a map or a gradient, as a share of the largest
# element of the predictions or of all the gradients.
ATOL_SHARE = 1e-9


@pytest.mark.parametrize("autotune", [True, False],
                         ids=["autotuned", "heuristics"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_conv_memory_format(device, dtype, autotune):
    """Contiguous NCHW for float32 on a CUDA device that autotunes, and
    channels_last for every other case; the argument decides, not
    ``torch.backends.cudnn.benchmark``."""
    want = (torch.contiguous_format
            if (device, dtype, autotune) == ("cuda", torch.float32, True)
            else torch.channels_last)
    assert conv_memory_format(device, dtype, autotune) == want
    assert conv_memory_format(torch.device(device, 0), dtype,
                              autotune) == want


@pytest.mark.parametrize("deterministic, use_benchmark, want", [
    (False, True, True), (False, False, False), (True, True, False)],
    ids=["autotuned", "use-benchmark-off", "deterministic"])
def test_configure_backends_returns_whether_cudnn_autotunes(
        deterministic, use_benchmark, want, monkeypatch):
    from monocon_tpu_torch.config import get_default_cfg
    from monocon_tpu_torch.train import CUBLAS_WORKSPACE, configure_backends

    cudnn = torch.backends.cudnn
    for name in ("benchmark", "deterministic", "allow_tf32"):
        monkeypatch.setattr(cudnn, name, getattr(cudnn, name))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch, "use_deterministic_algorithms",
                        lambda flag: None)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    cfg = get_default_cfg()
    cfg.USE_BENCHMARK = use_benchmark
    assert configure_backends(cfg, deterministic) is want
    assert cudnn.benchmark is want


def held_channels_last(model):
    weight = model.backbone.base_layer[0].weight
    return (model.memory_format == torch.channels_last
            and weight.is_contiguous(memory_format=torch.channels_last)
            and not weight.is_contiguous())


def test_cpu_bf16_detector_is_built_channels_last():
    assert held_channels_last(
        create_detector(device="cpu", compute_dtype=torch.bfloat16))


@pytest.mark.parametrize("fmt", [torch.channels_last,
                                 torch.contiguous_format],
                         ids=["channels_last", "contiguous"])
def test_create_detector_holds_the_format_it_is_given(fmt):
    model = create_detector(device="cpu", memory_format=fmt)
    assert model.memory_format == fmt
    for name, p in model.named_parameters():
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=fmt), name


@pytest.fixture(scope="module")
def stepped():
    """One train step of the channels_last detector and of its copy in
    contiguous NCHW, on the same batch: (predictions, losses, gradients)
    of each, and the two models."""
    rng = np.random.default_rng(14)
    label = {k: torch.from_numpy(v) for k, v in random_label_batch(
        rng, b=BATCH, o=30, feat_hw=(HW[0] // 4, HW[1] // 4),
        pad_hw=HW).items()}
    batch = {"img": torch.from_numpy(rng.normal(size=(BATCH, *HW, 3))),
             "label": label}
    last = create_detector(device="cpu").double()
    nchw = copy.deepcopy(last).to_memory_format(torch.contiguous_format)
    out = {}
    for name, model in (("channels_last", last), ("contiguous", nchw)):
        with torch.no_grad():
            pred = model.eval()(batch["img"])
        model.train()
        optimizer, solver = build_optimizer(model.parameters(),
                                            total_steps=10)
        losses = train_step(model, optimizer, solver, batch)
        out[name] = (pred, losses, {k: p.grad for k, p in
                                    model.named_parameters()}, model)
    return out


def test_cpu_f32_detector_is_built_channels_last(stepped):
    assert held_channels_last(stepped["channels_last"][3])


def test_contiguous_model_holds_nchw_weights(stepped):
    model = stepped["contiguous"][3]
    assert model.memory_format == torch.contiguous_format
    for name, p in model.named_parameters():
        assert p.is_contiguous(), name
    weight = model.backbone.base_layer[0].weight
    assert not weight.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("name", ["channels_last", "contiguous"])
def test_predictions_are_contiguous_nhwc(stepped, name):
    pred = stepped[name][0]
    assert len(pred) == 10
    for key, value in pred.items():
        assert value.dtype == torch.float32, key
        assert value.shape[1:3] == (HW[0] // 4, HW[1] // 4), key
        assert value.is_contiguous(), key


def test_step_matches_channels_last(stepped):
    """Eval predictions, the eleven losses and every parameter's gradient
    of one train step agree between the two formats."""
    (pred_a, loss_a, grad_a, _), (pred_b, loss_b, grad_b, _) = (
        stepped["channels_last"], stepped["contiguous"])
    for got, want in ((pred_b, pred_a), (grad_b, grad_a)):
        assert set(got) == set(want)
        atol = ATOL_SHARE * max(float(v.abs().max()) for v in want.values())
        for key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       rtol=RTOL, atol=atol)
    assert set(loss_a) == set(loss_b) and len(loss_a) == 11
    for key in loss_a:
        np.testing.assert_allclose(float(loss_b[key]), float(loss_a[key]),
                                   err_msg=key, rtol=RTOL)
