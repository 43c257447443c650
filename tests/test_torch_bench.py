"""``python -m monocon_tpu_torch.bench``: the root ``bench.py``'s JSON
keys from a CPU run, and its FLOP count against the multiply-adds of the
model's convolutions, transposed convolutions and matrix products at a
small canvas."""

import json

import pytest
import torch
from torch import nn

import torch_port_helpers  # noqa: F401 -- caps torch's threads
from monocon_tpu_torch import bench
from monocon_tpu_torch.models.layers import AttnBatchNorm

# The root bench.py's keys (bench.py:153-169), and the device the run
# names.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "torch_fps",
              "device_ms_per_step", "device_fps", "mfu_pct", "batch",
              "dtype", "device"}
SMALL_HW = (64, 160)
TOP_K = 30


def test_bench_prints_bench_py_keys_on_the_cpu(monkeypatch, capsys):
    """A CPU run has no device time and no peak: those keys are null, as
    are the reference's; the rate is a positive number."""
    monkeypatch.setenv("BENCH_BATCH", "1")
    monkeypatch.setenv("BENCH_ITERS", "1")
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert set(result) == BENCH_KEYS
    assert result["value"] > 0 and result["unit"] == "frames/sec/chip"
    assert (result["batch"], result["dtype"], result["device"]) == (
        1, "bfloat16", "cpu")
    for key in ("vs_baseline", "torch_fps", "device_ms_per_step",
                "device_fps", "mfu_pct"):
        assert result[key] is None, key
    assert "DLA-34" in result["metric"]


def test_bench_refuses_an_unknown_dtype(monkeypatch):
    monkeypatch.setenv("BENCH_DTYPE", "float16")
    with pytest.raises(ValueError, match="BENCH_DTYPE"):
        bench.settings()


def test_flop_count_is_twice_the_multiply_adds():
    """FlopCounterMode's count over one forward + decode at 64x160 equals 2
    x the multiply-adds from the shapes each convolution and transposed
    convolution saw, the attention mixes of the AttnBatchNorms ((B, K) x
    (K, C), two a layer) and the decode's batched 4 x 4 unprojection of
    the top 30."""
    model, forward, image, p2 = bench.make_forward(
        34, "float32", 1, torch.device("cpu"), SMALL_HW)
    macs = []

    def conv(module, inputs, output):
        kh, kw = module.kernel_size
        if isinstance(module, nn.ConvTranspose2d):
            macs.append(inputs[0].numel() * module.out_channels
                        // module.groups * kh * kw)
        else:
            macs.append(output.numel() * module.in_channels
                        // module.groups * kh * kw)

    def attn(module, inputs, output):
        k, c = module.weight_.shape
        macs.append(2 * inputs[0].shape[0] * k * c)

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    hooks += [m.register_forward_hook(attn) for m in model.modules()
              if isinstance(m, AttnBatchNorm)]
    try:
        flops = bench.count_flops(forward, image, p2)
    finally:
        for h in hooks:
            h.remove()
    assert len(macs) > 90
    assert flops == 2 * (sum(macs) + image.shape[0] * TOP_K * 4 * 4)
