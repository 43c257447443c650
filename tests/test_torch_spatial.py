"""The image height split over ranks (``TPU.SPATIAL_SHARDS > 1``) on the
CPU: one data shard of two bands at 128x64, two gloo ranks
(``tests/torch_spatial_worker.py``, spawned once for the file), against
one process on the whole images and against the JAX package's spatial
mesh (``make_mesh(2, spatial=2)`` on two of conftest's virtual devices);
and the layout's pure functions.

Everything runs in float64 (the JAX side under ``jax.enable_x64``), as in
``tests/test_torch_parallel.py``, where the layouts differ only by the
order of their sums:

  * one DLA-34 train step: 11 losses, the gradients and the BN running
    stats against one process at rtol 1e-5 / atol 1e-6, the losses
    against the JAX mesh step at rtol 1e-4, parameters bit-equal on both
    ranks;
  * the eval forward's head maps against one process (rtol 1e-5 / atol
    1e-6) and the JAX mesh forward (rtol 5e-4 / atol 1e-5, as
    ``tests/test_parallel.py`` holds the JAX mesh to one device);
  * every 4D output of the backbone's and the neck's modules has its
    band's height on each rank, never the whole canvas's;
  * ``gradcheck`` of a halo exchange and a row gather over the two ranks;
  * the losses, gradients, buffers, eval maps and band heights again with
    the ranks' detector in contiguous NCHW, the format float32 runs in
    on a CUDA device, against the same one process (channels_last).

``tests/test_torch_spatial_layouts.py`` runs the same checks on 2x2 ranks
with a padded remainder, ``tests/test_torch_spatial_uneven.py`` on 1x4
with uneven bands.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocon_tpu_torch.config import get_default_cfg
from monocon_tpu_torch.engine.train_step import train_step
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.ops.image_norm import normalize_if_raw
from monocon_tpu_torch.parallel import (band_rows, max_safe_spatial_shards,
                                        num_processes, rank_rows,
                                        validate_spatial_shards)
from monocon_tpu_torch.parallel.distributed import free_port
from monocon_tpu_torch.solver.schedule import build_optimizer
from tests.test_ops_parity import random_label_batch
from tests.torch_port_helpers import jax_x64_tree

ROOT = Path(__file__).resolve().parent.parent
# The rank layouts against one process; against the JAX mesh.
PARALLEL_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_RTOL = 1e-4
JAX_MAP_TOL = dict(rtol=5e-4, atol=1e-5)
WORKER_TIMEOUT_S = 600
# The layout of this file: (world, spatial, canvas, batch, real rows).
LAYOUT = dict(world=2, spatial=2, hw=(128, 64), batch=2, num_real=2)


# ------------------------------------------------------------ shared pieces
def layout_inputs(hw, batch, num_real, spatial, seed):
    """The inputs of one layout's ranks: DLA-34 weights (the port's init
    from a seed, BN running stats and biases randomised), ``num_real``
    float64 images and labels of a global batch of ``batch``."""
    rng = np.random.default_rng(seed)
    model = create_detector(generator=torch.Generator().manual_seed(0),
                            device="cpu")
    state = model.state_dict()
    for key, value in state.items():
        if key.endswith(("running_mean", "bias")):
            value.add_(torch.from_numpy(
                rng.normal(0, 0.1, value.shape).astype(np.float32)))
        elif key.endswith("running_var"):
            value.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, value.shape).astype(np.float32)))
    label = {k: torch.from_numpy(v) for k, v in random_label_batch(
        rng, b=num_real, o=30, feat_hw=(hw[0] // 4, hw[1] // 4),
        pad_hw=hw).items()}
    return dict(state=state, img=torch.from_numpy(
        rng.normal(size=(num_real, *hw, 3))), label=label,
        batch_size=batch, spatial=spatial)


def launch_ranks(data, world, folder: Path):
    """The layout's ranks, started on ``data``: (process, results file)
    each."""
    path = folder / "inputs.pt"
    torch.save(data, path)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="1")
        out = folder / f"rank{rank}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_spatial_worker.py"),
             str(path), str(out)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out))
    return procs


def finish_ranks(procs):
    """Each rank's results, once every rank has finished; the files go."""
    results = []
    for proc, out in procs:
        log = proc.communicate(timeout=WORKER_TIMEOUT_S)[0]
        assert proc.returncode == 0, log[-4000:]
        results.append(torch.load(out, weights_only=False))
        out.unlink()
    return results


def kill_ranks(procs):
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()


def global_rows(data, world):
    """Source row of each row of the padded global batch, in rank order."""
    shards = world // data["spatial"]
    return [j for d in range(shards)
            for j, _ in rank_rows(data["batch_size"], len(data["img"]), d,
                                  shards)]


def one_process(data, world):
    """The port in this process, float64: the eval maps of the padded
    global batch, then one train step on the real rows alone."""
    model = create_detector(device="cpu")
    model.load_state_dict(data["state"])
    model = model.double().eval()
    with torch.no_grad():
        maps = model(data["img"][global_rows(data, world)])
    optimizer, solver = build_optimizer(model.parameters(), total_steps=10)
    losses = train_step(model, optimizer, solver,
                        {"img": data["img"], "label": data["label"]})
    return {"eval": maps,
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "buffers": {k: v.clone() for k, v in model.named_buffers()}}


def jax_mesh(data, world, spatial, with_eval=False):
    """The JAX package's step (and with ``with_eval`` its eval forward) on
    a ``world``-device mesh with ``spatial`` bands, float64, on the padded
    global batch with its ``valid`` rows."""
    from monocon_tpu.engine import create_train_state, make_train_step
    from monocon_tpu.models.detector import MonoConDetector as JaxDetector
    from monocon_tpu.parallel import make_mesh, replicate_state, shard_batch
    from monocon_tpu.solver import build_optimizer as jax_build
    from monocon_tpu.utils.torch_convert import convert_state_dict

    rows = global_rows(data, world)
    num_real = len(data["img"])
    variables = convert_state_dict({k: v.numpy()
                                    for k, v in data["state"].items()})
    out = {}
    with jax.enable_x64(True):
        batch = {"img": jnp.asarray(data["img"][rows].numpy()),
                 "label": {k: jnp.asarray(v[rows].numpy())
                           for k, v in data["label"].items()}}
        if data["batch_size"] > num_real:
            batch["valid"] = jnp.asarray(
                [float(i < num_real) for i in range(data["batch_size"])])
        mesh = make_mesh(world, spatial=spatial)
        tx = jax_build(total_steps=10)
        state = replicate_state(
            create_train_state(jax_x64_tree(variables), tx), mesh)
        step = jax.jit(make_train_step(JaxDetector(34), tx))
        with mesh:
            _, losses = step(state, shard_batch(batch, mesh))
        out["losses"] = {k: float(v) for k, v in losses.items()}
        if with_eval:
            model = JaxDetector(34)
            forward = jax.jit(lambda v, im: model.apply(v, im, train=False))
            with mesh:
                maps = forward(jax_x64_tree(variables),
                               shard_batch({"img": batch["img"]},
                                           mesh)["img"])
            out["eval"] = {k: np.asarray(v) for k, v in maps.items()}
    return out


def close(a, b, what, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=what, **tol)


def same_dicts(got, want, what, **tol):
    assert set(got) == set(want), what
    for key in want:
        close(got[key], want[key], f"{what} {key}", **tol)


def rank_maps(ranks, world, data):
    """The eval maps of the global batch from the ranks of the first band
    of each data shard, after checking that every band's rank returned
    its shard's whole maps."""
    spatial = data["spatial"]
    for r in ranks:
        first = ranks[r["data_index"] * spatial]
        for key, value in r["eval"].items():
            assert torch.equal(value, first["eval"][key]), key
    shards = [ranks[d * spatial] for d in range(world // spatial)]
    return {k: torch.cat([s["eval"][k] for s in shards])
            for k in shards[0]["eval"]}


def check_one_process(ranks, want, world, data):
    """Losses (every rank), gradients and BN buffers (rank 0), and eval
    maps equal one process's."""
    for r in ranks:
        same_dicts(r["losses"], want["losses"], "loss", **PARALLEL_TOL)
    same_dicts(ranks[0]["grads"]["values"], want["grads"], "grad",
               **PARALLEL_TOL)
    same_dicts(ranks[0]["buffers"]["values"], want["buffers"], "buffer",
               **PARALLEL_TOL)
    same_dicts(rank_maps(ranks, world, data), want["eval"], "eval map",
               **PARALLEL_TOL)


def check_band_heights(ranks, data):
    """Every 4D output of the backbone and the neck is its band's height
    at its stride on every rank, never the canvas's."""
    pad_h, pad_w = data["img"].shape[1:3]
    for r in ranks:
        start, stop = r["band"]
        assert r["band"] == band_rows(pad_h, data["spatial"],
                                      r["space_index"])
        assert len(r["heights"]) > 100
        for h, w in r["heights"]:
            stride = pad_w // w
            assert h == (stop - start) // stride < pad_h // stride, (h, w)


def check_ranks_agree(ranks):
    """Gradients, BN buffers and parameters bit-equal on every rank."""
    for key in ("grads", "buffers", "params"):
        assert len({r[key]["sha256"] for r in ranks}) == 1, key


def layout_fixtures(layout, seed, with_eval=False):
    """The module-scoped fixtures of one layout's file: ``inputs``,
    ``launched`` (its ranks, started), ``jax_results`` (the JAX mesh
    step, computed while the ranks run), ``ranks`` (their results) and
    ``reference`` (one process)."""

    @pytest.fixture(scope="module")
    def inputs():
        return layout_inputs(layout["hw"], layout["batch"],
                             layout["num_real"], layout["spatial"], seed)

    @pytest.fixture(scope="module")
    def launched(inputs, tmp_path_factory):
        procs = launch_ranks(inputs, layout["world"],
                             tmp_path_factory.mktemp("spatial"))
        yield procs
        kill_ranks(procs)

    @pytest.fixture(scope="module")
    def jax_results(launched, inputs):
        return jax_mesh(inputs, layout["world"], layout["spatial"],
                        with_eval)

    @pytest.fixture(scope="module")
    def ranks(launched):
        return finish_ranks(launched)

    @pytest.fixture(scope="module")
    def reference(inputs):
        return one_process(inputs, layout["world"])

    return inputs, launched, jax_results, ranks, reference


# ---------------------------------------------------------------- fixtures
inputs, launched, jax_results, ranks, reference = layout_fixtures(
    LAYOUT, seed=11, with_eval=True)


# --------------------------------------------------------------- the ranks
def check_jax_losses(ranks, jax_results):
    """Every rank's 11 losses against the JAX step on the same
    ``data x space`` mesh, padded rows masked by ``valid``."""
    assert len(jax_results["losses"]) == 11
    for r in ranks:
        same_dicts(r["losses"], jax_results["losses"], "loss", rtol=JAX_RTOL)


def test_step_matches_jax_spatial_mesh(jax_results, ranks):
    """Against the JAX package's step on a 1 x 2 (data x space) mesh."""
    check_jax_losses(ranks, jax_results)


def test_eval_maps_match_jax_spatial_mesh(inputs, jax_results, ranks):
    """The gathered head maps against the JAX mesh forward's."""
    same_dicts(rank_maps(ranks, LAYOUT["world"], inputs),
               jax_results["eval"], "eval map", **JAX_MAP_TOL)


def test_step_and_eval_match_one_process(inputs, ranks, reference):
    check_one_process(ranks, reference, LAYOUT["world"], inputs)


def test_ranks_hold_equal_parameters(ranks):
    check_ranks_agree(ranks)


def test_activations_have_band_height(inputs, ranks):
    check_band_heights(ranks, inputs)


def test_halo_exchange_and_gather_rows_gradcheck(ranks):
    """``gradcheck`` passes on every rank, and ``gather_rows`` puts the
    bands in space order at a map's stride."""
    for r in ranks:
        assert r["gradcheck"] and r["gather_rows"]


@pytest.fixture(scope="module")
def ranks_nchw(inputs, tmp_path_factory):
    """The layout's ranks with the detector in contiguous NCHW."""
    procs = launch_ranks(dict(inputs, memory_format=torch.contiguous_format),
                         LAYOUT["world"], tmp_path_factory.mktemp("nchw"))
    try:
        return finish_ranks(procs)
    finally:
        kill_ranks(procs)


def test_contiguous_format_matches_one_process(inputs, ranks_nchw,
                                               reference):
    """The halo exchanges and the head maps' row gather in contiguous
    NCHW: the same step and eval maps as one process, every rank alike,
    band-height activations."""
    check_one_process(ranks_nchw, reference, LAYOUT["world"], inputs)
    check_ranks_agree(ranks_nchw)
    check_band_heights(ranks_nchw, inputs)
    for r in ranks_nchw:
        assert r["gradcheck"] and r["gather_rows"]


# -------------------------------------------------------- pure functions
@pytest.mark.parametrize("pad_h, spatial, want", [
    (384, 2, [(0, 192), (192, 384)]),
    (320, 4, [(0, 96), (96, 192), (192, 256), (256, 320)]),
    (288, 4, [(0, 96), (96, 160), (160, 224), (224, 288)]),
    (128, 2, [(0, 64), (64, 128)]),
    (384, 6, [(i * 64, (i + 1) * 64) for i in range(6)]),
], ids=["384-2", "320-4-uneven", "288-4-no-empty-band", "128-2", "384-6"])
def test_band_rows(pad_h, spatial, want):
    """Whole rows of the H/32 map, split as evenly as they go."""
    assert [band_rows(pad_h, spatial, s) for s in range(spatial)] == want


def test_band_rows_tile_every_canvas_in_the_envelope():
    """Every canvas height (a multiple of 32 up to 2048) and every shard
    count the envelope admits: contiguous bands that cover the canvas,
    none empty, whole rows of the deepest map, at most one of them apart;
    and a canvas that is no multiple of 32 raises."""
    for pad_h in range(32, 2049, 32):
        for spatial in range(1, max_safe_spatial_shards(pad_h) + 1):
            bands = [band_rows(pad_h, spatial, s) for s in range(spatial)]
            assert bands[0][0] == 0 and bands[-1][1] == pad_h
            assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
            sizes = [b - a for a, b in bands]
            assert min(sizes) > 0 and all(n % 32 == 0 for n in sizes)
            assert max(sizes) - min(sizes) <= 32
    with pytest.raises(ValueError, match="multiple of the deepest"):
        band_rows(200, 2, 0)


def test_envelope_is_the_jax_package_s():
    """``max_safe_spatial_shards`` and ``validate_spatial_shards`` against
    the JAX package's over canvas heights 16..1024 and shard counts 1..9:
    the same limit, and the same refusals with the same message."""
    from monocon_tpu.parallel import mesh as jax_mesh_module

    for pad_h in range(16, 1025, 16):
        assert max_safe_spatial_shards(pad_h) == (
            jax_mesh_module.max_safe_spatial_shards(pad_h)), pad_h
        for spatial in range(1, 10):
            try:
                jax_mesh_module.validate_spatial_shards(pad_h, spatial)
                want = None
            except ValueError as err:
                want = str(err).split(":")[0]
            try:
                validate_spatial_shards(pad_h, spatial)
                got = None
            except ValueError as err:
                got = str(err).split(":")[0]
            assert got == want, (pad_h, spatial)


def test_band_normalisation_masks_from_its_first_row():
    """``normalize_if_raw`` on a band starting at ``row0`` masks the rows
    past each image's height as the whole canvas's normalisation does."""
    rng = np.random.default_rng(3)
    image = torch.from_numpy(rng.integers(0, 256, (3, 64, 40, 3),
                                          dtype=np.uint8))
    hw = torch.tensor([[64, 40], [37, 30], [20, 40]], dtype=torch.int32)
    whole = normalize_if_raw(image, hw)
    for start, stop in ((0, 32), (32, 64), (16, 48)):
        band = normalize_if_raw(image[:, start:stop], hw, row0=start)
        assert torch.equal(band, whole[:, start:stop])
    assert not whole[1, 37:].any() and whole[1, :37, :30].any()


@pytest.mark.parametrize("asked, visible, batch, spatial, want", [
    (4, 0, 8, 2, 4), (3, 0, 8, 2, 2), (8, 0, 6, 2, 6), (-1, 8, 8, 2, 8),
    (-1, 8, 5, 4, 4), (16, 4, 8, 2, 4), (1, 0, 8, 2, None),
    (-1, 0, 8, 2, None), (-1, 1, 8, 2, None)],
    ids=["cpu-2x2", "cpu-1x2", "cpu-clamped-3x2", "gpu-4x2",
         "gpu-clamped-1x4", "gpu-more-than-visible", "cpu-too-few",
         "cpu-default", "gpu-too-few"])
def test_num_processes_counts_data_shards_times_bands(
        asked, visible, batch, spatial, want, monkeypatch):
    """``D x S`` processes, ``D`` the largest count at most the devices
    over ``S`` that divides the batch; fewer devices than ``S`` raise
    rather than fall back to one band."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    cfg = get_default_cfg()
    cfg.TPU.NUM_DEVICES, cfg.DATA.BATCH_SIZE = asked, batch
    cfg.TPU.SPATIAL_SHARDS = spatial
    device = torch.device("cuda" if visible else "cpu")
    if want is None:
        with pytest.raises(ValueError, match="SPATIAL_SHARDS"):
            num_processes(cfg, device)
    else:
        assert num_processes(cfg, device) == want
