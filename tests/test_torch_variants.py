"""DLA-46, 60 and 102 in the port against the JAX package on the same
weights: the converted state dict key by key against ``export_state_dict``,
the head widths, the six backbone levels and the detector's head maps in
float32 (eval and train mode, with the BN running stats), and the ImageNet
backbone import."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocon_tpu.models.detector import MonoConDetector as JaxDetector
from monocon_tpu.models.dla import DLA as JaxDLA
from monocon_tpu.utils.torch_convert import (convert_state_dict,
                                             export_state_dict)
from monocon_tpu.utils.torch_convert import (
    load_imagenet_backbone as jax_load_imagenet_backbone,
)
from monocon_tpu_torch.engine.checkpoint import load_imagenet_backbone
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_helpers import F32_TOL, default_threads, perturb_variables  # noqa: F401

HW = (64, 96)
VARIANTS = (46, 60, 102)
# Backbone levels (tests/test_dla_variants.py:48-60), from the reference's
# init: float32 noise grows through the deeper bottleneck trees, and
# DLA-102's residual roots carry its random-init activations to about 1e6,
# so it is held relative to each level's largest value.
LEVEL_TOL = dict(rtol=1e-3, atol=2e-3)
SCALE_TOL = 1e-4
# DLA-102's head maps and running stats, relative to each tensor's largest
# value: train-mode ``wh`` measured 1.35e-4 on the CPU.
HEAD_SCALE_TOL = 1e-3


@pytest.fixture(scope="module")
def jax_variants():
    """Per variant: the JAX detector, its variables as initialised (the
    reference's init: BN running mean 0, variance 1) and a copy with random
    BN state. The variables come from the port's random init through the
    JAX package's own ``.pth`` importer, which is much quicker here than
    compiling the JAX init of three detectors."""
    out = {}
    for num_layers in VARIANTS:
        model = create_detector(
            num_layers, generator=torch.Generator().manual_seed(num_layers),
            device="cpu")
        variables = convert_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()})
        out[num_layers] = (JaxDetector(num_layers=num_layers), variables,
                           perturb_variables(variables,
                                             np.random.default_rng(num_layers)))
    return out


def port_variant(num_layers, variables):
    model = create_detector(num_layers, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _close(got, want, what, num_layers):
    if num_layers == 102:
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < SCALE_TOL, f"dla102 {what}: {err:.2e}"
    else:
        np.testing.assert_allclose(got, want, err_msg=f"dla{num_layers} "
                                   f"{what}", **LEVEL_TOL)


@pytest.mark.parametrize("num_layers", VARIANTS)
def test_state_dict_matches_export_state_dict(jax_variants, num_layers):
    """``conv3``/``bn3`` of the Bottlenecks, the residual roots and the
    128-wide heads map key by key as the JAX exporter maps them, and load
    strictly."""
    _, _, variables = jax_variants[num_layers]
    ours = state_dict_from_jax(variables)
    theirs = export_state_dict(variables)
    assert set(ours) == set(theirs)
    assert any(".conv3." in k for k in ours)
    for key, val in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    model = create_detector(num_layers, device="cpu")
    assert set(model.state_dict()) == set(ours)
    model.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("num_layers, width", [(46, 64), (60, 128),
                                               (102, 128)])
def test_head_width(num_layers, width):
    """Each head's hidden width is the reference's: 64 for DLA-34/46, 128
    for DLA-60/102."""
    head = create_detector(num_layers, device="cpu").head
    for name, module in head.named_children():
        conv = module[0]
        if name in ("dir_cls", "dir_reg"):
            assert (conv.in_channels, conv.out_channels) == (width, 12), name
        else:
            assert (conv.in_channels, conv.out_channels) == (width, width), name


@pytest.mark.parametrize("num_layers", VARIANTS)
def test_backbone_levels_match_jax(jax_variants, num_layers, rng):
    """The six levels of the port's backbone (plain stem) against JAX's
    ``DLA`` (its default W-block stem) in eval mode."""
    _, variables, _ = jax_variants[num_layers]
    x = rng.normal(size=(1, *HW, 3)).astype(np.float32)
    theirs = JaxDLA(num_layers).apply(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"]["backbone"]},
        jnp.asarray(x), train=False)
    port = port_variant(num_layers, variables).eval()
    with torch.no_grad():
        ours = port.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(ours) == len(theirs) == 6
    for i, (a, b) in enumerate(zip(ours, theirs)):
        _close(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), f"level{i}",
               num_layers)


@pytest.mark.parametrize("num_layers", VARIANTS)
@pytest.mark.usefixtures("default_threads")
def test_detector_matches_jax(jax_variants, num_layers, rng):
    """Every head map in eval mode, then in train mode with every BN
    running stat, at the parity tolerance, from random BN state; DLA-102's
    relative to each
    tensor's largest value (its eval-mode maps reach 1e5)."""
    model, _, variables = jax_variants[num_layers]
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    port = port_variant(num_layers, variables)

    def close(got, want, what):
        if num_layers == 102:
            err = np.max(np.abs(got - want)) / np.max(np.abs(want))
            assert err < HEAD_SCALE_TOL, f"dla102 {what}: {err:.2e}"
        else:
            np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)

    theirs = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = port.eval()(torch.from_numpy(x))
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        close(ours[key].numpy(), np.asarray(want), f"eval {key}")

    theirs, new = model.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    with torch.no_grad():
        ours = port.train()(torch.from_numpy(x))
    for key, want in theirs.items():
        close(ours[key].numpy(), np.asarray(want), f"train {key}")
    expected = state_dict_from_jax({"params": variables["params"],
                                    "batch_stats": new["batch_stats"]})
    got = port.state_dict()
    stats = [k for k in expected if "running_" in k]
    assert len(stats) > 100
    for key in stats:
        close(got[key].numpy(), expected[key].numpy(), key)


def test_imagenet_backbone_of_a_variant(jax_variants, tmp_path):
    """A DLA-102 ImageNet-format ``.pth`` (no ``backbone.`` prefix, an
    ``fc`` head): the port's backbone gets what JAX's
    ``load_imagenet_backbone`` converts."""
    _, _, variables = jax_variants[102]
    full = state_dict_from_jax(variables)
    imagenet = {k[len("backbone."):]: v for k, v in full.items()
                if k.startswith("backbone.")}
    imagenet["fc.weight"] = torch.ones(1000, 1024, 1, 1)
    imagenet["fc.bias"] = torch.zeros(1000)
    path = tmp_path / "dla102-imagenet.pth"
    torch.save(imagenet, path)

    model = create_detector(102, device="cpu")
    load_imagenet_backbone(str(path), model)
    jax_bb = jax_load_imagenet_backbone(str(path))
    want = state_dict_from_jax({
        "params": {**variables["params"],
                   "backbone": jax_bb["params"]["backbone"]},
        "batch_stats": {**variables["batch_stats"],
                        "backbone": jax_bb["batch_stats"]["backbone"]}})
    got = model.state_dict()
    backbone = [k for k in got if k.startswith("backbone.")
                and not k.endswith("num_batches_tracked")]
    assert len(backbone) > 300
    for key in backbone:
        assert torch.equal(got[key], want[key]), key
