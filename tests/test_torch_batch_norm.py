"""Train-mode batch norm of contiguous NCHW tensors (``ops/batch_norm.py``):
the kernels' split of the grid, what they refuse, and which path
``models/layers.py::BatchNorm2d`` takes. On the card the kernels are held
to ``F.batch_norm`` by ``chip_smoke.py``'s ``phase_batch_norm``; the test
marked ``cuda`` does the same where pytest runs beside a card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from monocon_tpu_torch.models.layers import BatchNorm2d
from monocon_tpu_torch.ops import batch_norm as bn


def bn_inputs(rng, shape, affine, dtype):
    c = shape[1]
    x = torch.from_numpy(rng.normal(0.5, 2.0, shape)).to(dtype)
    grad = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    weight = (torch.from_numpy(rng.uniform(0.5, 1.5, c)).to(dtype)
              if affine else None)
    bias = torch.from_numpy(rng.normal(size=c)).to(dtype) if affine else None
    return x, grad, weight, bias


def run(fn, x, grad, weight, bias):
    """Output, running stats and the gradients of x, weight and bias."""
    leaves = [t.clone().requires_grad_(True) if t is not None else None
              for t in (x, weight, bias)]
    c = x.shape[1]
    running = [torch.full((c,), 0.3, dtype=x.dtype, device=x.device),
               torch.full((c,), 2.0, dtype=x.dtype, device=x.device)]
    out = fn(*leaves, *running)
    out.backward(grad)
    return [out.detach(), *running] + [t.grad for t in leaves
                                       if t is not None]


@pytest.mark.parametrize("b, c, hw", [
    (8, 16, 384 * 1248), (8, 64, 96 * 312), (8, 512, 12 * 39),
    (8, 1024, 12 * 39), (1, 3, 35), (2, 3, 1), (8, 2, 10 ** 6),
    (8, 1, 384 * 1248)])
def test_split_covers_each_row_once(b, c, hw):
    """Whole steps of ``BLOCK``, chunks that cover the row with none
    empty, and about ``TARGET_PROGRAMS`` programs where a row has room."""
    chunks, chunk = bn.split(b, c, hw)
    assert chunk % bn.BLOCK == 0 and chunk > 0
    assert (chunks - 1) * chunk < hw <= chunks * chunk
    most = -(-hw // bn.BLOCK)
    assert chunks == most or b * c * chunks >= bn.TARGET_PROGRAMS // 2


@pytest.mark.parametrize("x", [
    torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 4, 5, dtype=torch.float64),
    torch.zeros(3, 4, 5),
    torch.zeros(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)],
    ids=["cpu", "float64", "3d", "channels_last"])
def test_kernels_take_only_contiguous_f32_cuda_tensors(x):
    """Nothing falls back: the kernels have no CPU mode."""
    ones = torch.ones(3)
    with pytest.raises(ValueError, match="contiguous NCHW float32 CUDA"):
        bn.batch_norm_nchw(x, ones, ones, ones.clone(), ones.clone(), 0.1,
                           1e-5)


@pytest.mark.parametrize("fmt", [torch.channels_last,
                                 torch.contiguous_format],
                         ids=["channels_last", "contiguous"])
def test_cpu_layer_runs_as_nn_batch_norm(fmt, rng):
    """On the CPU both layouts take ``nn.BatchNorm2d``'s own path, bit for
    bit: the kernels' path is for CUDA tensors alone."""
    x = torch.from_numpy(rng.normal(size=(2, 8, 6, 10)).astype(np.float32)
                         ).contiguous(memory_format=fmt)
    ours, plain = BatchNorm2d(8), torch.nn.BatchNorm2d(8)
    with torch.no_grad():
        ours.weight.uniform_(0.5, 1.5)
    plain.load_state_dict(ours.state_dict())
    before = bn.launch_count
    assert torch.equal(ours.train()(x), plain.train()(x))
    assert torch.equal(ours.running_var, plain.running_var)
    assert int(ours.num_batches_tracked) == 1
    assert bn.launch_count == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape, affine", [
    ((8, 16, 384, 1248), True), ((8, 64, 96, 312), False),
    ((8, 512, 12, 39), True), ((2, 3, 5, 7), True)])
def test_kernels_match_f_batch_norm(shape, affine, rng):
    """The kernels and ``F.batch_norm`` in float32, against
    ``F.batch_norm`` in float64: the kernels' error at most twice the
    float32 one's, plus 1e-6 of the value's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    args = [t.cuda() if t is not None else None
            for t in bn_inputs(rng, shape, affine, torch.float64)]

    def kernels(x, weight, bias, mean, var):
        return bn.batch_norm_nchw(x, weight, bias, mean, var, 0.1, 1e-5)

    def plain(x, weight, bias, mean, var):
        return F.batch_norm(x, mean, var, weight, bias, True, 0.1, 1e-5)

    def f32(t):
        return t.float() if t is not None else None

    before = bn.launch_count
    got = run(kernels, *map(f32, args))
    assert bn.launch_count == before + 4
    for a, b, want in zip(got, run(plain, *map(f32, args)),
                          run(plain, *args)):
        err = float((a.double() - want).abs().max())
        limit = (2 * float((b.double() - want).abs().max())
                 + 1e-6 * float(want.abs().max()))
        assert err <= limit
