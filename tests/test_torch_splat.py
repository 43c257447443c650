"""The port's Gaussian splat: its plain version against the JAX dense path
and the Pallas kernel (interpret mode) on the edge cases, the dispatch by
device, and the CUDA kernel against the plain version on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import border_instances
from monocon_tpu_torch.ops.splat import TILE_H, TILE_W
from tests.torch_port_helpers import SPLAT_TOL

# (b, n, c, h, w, case): w=200 is a multiple of nothing in particular;
# "empty" makes one batch element all-invalid; "r0" has radius 0 only;
# the keypoint layout of the training path (N = O*K); W=77, H=23, neither
# a multiple of 4 nor of the kernel's tile; N=600, more than one round of
# the kernel's cull; one channel; "borders" puts boxes on each side of a
# tile border (chip_smoke.border_instances).
CASES = [
    (2, 12, 3, 32, 200, "plain"),
    (2, 8, 1, 24, 128, "empty"),
    (2, 16, 3, 24, 80, "r0"),
    (2, 270, 9, 24, 80, "plain"),
    (2, 20, 3, 23, 77, "plain"),
    (2, 600, 9, 24, 80, "plain"),
    (2, 12, 1, 24, 80, "plain"),
    (2, 8, 8, 2 * TILE_H + 8, 2 * TILE_W + 32, "borders"),
]


def random_instances(rng, b, n, c, h, w, case="plain"):
    """Centres in -5..w+5 / -5..h+5, radii 0..14, 70% valid (numpy)."""
    if case == "borders":
        return tuple(border_instances(b, TILE_H, TILE_W))
    centers = np.stack([rng.integers(-5, w + 5, (b, n)),
                        rng.integers(-5, h + 5, (b, n))], -1).astype(np.int32)
    radius = rng.integers(0, 15, (b, n)).astype(np.int32)
    if case == "r0":
        radius[:] = 0
    chan = rng.integers(0, c, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) < 0.7
    if case == "empty":
        valid[1] = False
    return centers, radius, chan, valid


def _port_plain(args, c, h, w):
    from monocon_tpu_torch.ops.splat import splat_max_heatmap

    return splat_max_heatmap(*(torch.from_numpy(a) for a in args), c, h, w)


@pytest.mark.parametrize("oracle", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("b,n,c,h,w,case", CASES)
def test_plain_splat_matches_jax(b, n, c, h, w, case, oracle, rng):
    from monocon_tpu.ops.gaussian import splat_max_heatmap
    from monocon_tpu.ops.pallas_splat import splat_max_heatmap_pallas

    args = random_instances(rng, b, n, c, h, w, case)
    jargs = [jnp.asarray(a) for a in args]
    if oracle == "jnp":
        theirs = splat_max_heatmap(*jargs, c, h, w)
    else:
        theirs = splat_max_heatmap_pallas(*jargs, c, h, w, interpret=True)
    ours = _port_plain(args, c, h, w)
    assert ours.shape == (b, c, h, w) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **SPLAT_TOL)
    if case == "empty":
        assert float(ours[1].max()) == 0.0


def test_cpu_tensors_take_the_plain_version(rng):
    from monocon_tpu_torch.ops import splat

    args = random_instances(rng, 2, 12, 3, 24, 80)
    before = splat.launch_count
    out = _port_plain(args, 3, 24, 80)
    assert splat.launch_count == before
    expected = splat.splat_max_heatmap_plain(
        *(torch.from_numpy(a) for a in args), 3, 24, 80)
    assert torch.equal(out, expected)


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """The CUDA wrapper launches the kernel or raises: it never computes
    on the CPU itself."""
    from monocon_tpu_torch.ops import splat

    args = random_instances(rng, 2, 12, 3, 24, 80)
    with pytest.raises(ValueError, match="CUDA"):
        splat.splat_max_heatmap_cuda(*(torch.from_numpy(a) for a in args),
                                     3, 24, 80)


# On the card also the main path's two shapes, and N=3000, whose shared
# list (20 bytes an instance) needs more than the default 48 KB.
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,h,w,case", CASES + [
    (8, 30, 3, 96, 320, "plain"), (8, 270, 9, 96, 320, "plain"),
    (2, 3000, 9, 24, 80, "plain")])
def test_kernel_matches_plain(b, n, c, h, w, case, rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from monocon_tpu_torch.ops import splat

    args = [torch.from_numpy(a).cuda()
            for a in random_instances(rng, b, n, c, h, w, case)]
    before = splat.launch_count
    got = splat.splat_max_heatmap(*args, c, h, w)
    torch.cuda.synchronize()
    assert splat.launch_count == before + 1
    want = splat.splat_max_heatmap_plain(*args, c, h, w)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_kernel_refuses_more_instances_than_its_shared_list_holds(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from chip_smoke import TOO_MANY_N
    from monocon_tpu_torch.ops import splat

    args = [torch.from_numpy(a).cuda()
            for a in random_instances(rng, 1, TOO_MANY_N, 3, 24, 80)]
    before = splat.launch_count
    with pytest.raises(ValueError, match="shared-memory list"):
        splat.splat_max_heatmap_cuda(*args, 3, 24, 80)
    assert splat.launch_count == before
