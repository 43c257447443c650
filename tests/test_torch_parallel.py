"""The port's data parallelism on the CPU: two gloo ranks
(``tests/torch_parallel_worker.py``, spawned once for the file) against
one process on the whole batch and against the JAX package's mesh step
on two of conftest's virtual devices.

Everything runs in float64 (the JAX side under ``jax.enable_x64``), where
the two rank layouts differ only by the order of their sums:

  * BatchNorm, ``MomentsBatchNorm`` (one row a rank, so the global n=2
    Bessel rule applies) and ``AttnBatchNorm`` synced over the ranks,
    unmasked and with a padded row, against the module on the valid rows
    of the whole batch: outputs, input gradients, running stats;
  * one DLA-34 step at 64x96, global batch 4 (2 a rank), through
    ``data_parallel`` with accumulation k=2: each micro-step's 11 losses
    against the JAX mesh step (``make_train_step`` with ``MultiSteps``)
    at rtol 1e-4, and losses, all-reduced gradients and BN running stats
    against the port's one process at rtol 1e-5 / atol 1e-6; the mean
    gradient AdamW takes after the second micro-step against
    ``MultiSteps``' (optax's first moment), and the updated weights
    against AdamW's closed form on it;
  * a remainder of 3 rows padded to 4 over the two ranks against one
    process's short batch of 3;
  * both ranks' gradients, BN buffers and parameters bit-equal after
    their steps (rank 0 writes the tensors, both their SHA-256).

The workers' files are deleted once read: together they hold about 1 GB.
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
from monocon_tpu_torch.models import layers
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.parallel import launch, num_processes, rank_rows
from monocon_tpu_torch.parallel.distributed import free_port
from monocon_tpu_torch.solver.schedule import WEIGHT_DECAY, build_optimizer
from monocon_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_ops_parity import random_label_batch
from tests.test_torch_train import F32_EPS, _adam_first_moment
from tests.torch_parallel_worker import BN_MODULES
from tests.torch_port_helpers import F64_TOL, jax_x64_tree

ROOT = Path(__file__).resolve().parent.parent
HW, FEAT_HW = (64, 96), (16, 24)
BATCH, WORLD, REMAINDER = 4, 2, 3
# The rank layouts against one process; the port against the JAX mesh.
PARALLEL_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_RTOL = 1e-4
WORKER_TIMEOUT_S = 600


def _bn_cases(rng):
    """name -> module kind, its state, input, loss weights and real rows.
    Each case's global batch splits over the two ranks; "masked" ones
    have one padding row (a repeat of row 0), as the loader pads."""
    cases = {}
    for kind, shape in (("batch_norm", (BATCH, 8, 5, 6)),
                        ("moments", (WORLD, 4, 1, 1)),
                        ("attn", (BATCH, 8, 5, 6))):
        torch.manual_seed(int(rng.integers(1 << 31)))
        module = BN_MODULES[kind]().double()
        with torch.no_grad():
            for name, t in module.named_parameters():
                t.copy_(torch.from_numpy(rng.normal(1.0 if "weight" in name
                                                    else 0.0, 0.3, t.shape)))
            module.running_mean.copy_(torch.from_numpy(
                rng.normal(0, 0.5, module.running_mean.shape)))
        x = torch.from_numpy(rng.normal(0.7, 2.0, shape))
        weight = torch.from_numpy(rng.normal(size=shape))
        for masked in (False, True):
            real = shape[0] - 1 if masked else shape[0]
            # The padding row repeats row 0, as the loader pads.
            x_case = torch.cat([x[:real], x[:shape[0] - real]])
            cases[f"{kind}-{'masked' if masked else 'full'}"] = dict(
                module=kind, state=module.state_dict(), x=x_case,
                weight=weight, num_real=real)
    return cases


def _label(rng, b):
    return {k: torch.from_numpy(v) for k, v in random_label_batch(
        rng, b=b, o=30, feat_hw=FEAT_HW, pad_hw=HW).items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The checks' inputs, written to ``inputs.pt``: DLA-34 weights (the
    port's init from a seed, BN running stats and affines randomised),
    two global batches, the 3-row remainder, the BN cases."""
    rng = np.random.default_rng(7)
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
    batches = [{"img": torch.from_numpy(rng.normal(size=(BATCH, *HW, 3))),
                "label": _label(rng, BATCH)} for _ in range(2)]
    remainder = {"img": torch.from_numpy(rng.normal(size=(REMAINDER, *HW,
                                                           3))),
                 "label": _label(rng, REMAINDER)}
    data = dict(state=state, batches=batches, remainder=remainder,
                batch_size=BATCH, bn=_bn_cases(rng))
    path = tmp_path_factory.mktemp("parallel") / "inputs.pt"
    torch.save(data, path)
    yield data, path
    path.unlink()


@pytest.fixture(scope="module")
def launched(inputs):
    """The two ranks, started: (process, its results file) each."""
    _, path = inputs
    port = free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT))
        out = path.parent / f"rank{rank}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"),
             str(path), str(out)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out))
    yield procs
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module")
def ranks(launched):
    """Each rank's results, once both have finished."""
    results = []
    for proc, out in launched:
        log = proc.communicate(timeout=WORKER_TIMEOUT_S)[0]
        assert proc.returncode == 0, log[-4000:]
        results.append(torch.load(out, weights_only=False))
        out.unlink()
    return results


def _one_process_step(state, batches, grad_accum):
    """The port on the whole batches in this process, float64: per step
    the losses, gradients and buffers; and the final parameters."""
    model = create_detector(device="cpu")
    model.load_state_dict(state)
    model = model.double()
    optimizer, solver = build_optimizer(model.parameters(), total_steps=10,
                                        grad_accum=grad_accum)
    steps = []
    for batch in batches:
        losses = train_step(model, optimizer, solver, batch)
        steps.append({
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "buffers": {k: v.clone() for k, v in model.named_buffers()}})
    return steps, {k: v.detach().clone() for k, v in model.named_parameters()}


@pytest.fixture(scope="module")
def one_process(inputs):
    data, _ = inputs
    accum = _one_process_step(data["state"], data["batches"], 2)
    remainder = _one_process_step(data["state"], [data["remainder"]], 1)
    return {"accum": accum, "remainder": remainder}


@pytest.fixture(scope="module")
def jax_mesh(inputs):
    """``make_train_step`` with ``MultiSteps`` (k=2) on a 2-device mesh,
    float64: each micro-step's losses, then the mean gradient AdamW took
    (optax's first moment / (1 - b1)) and the updated weights."""
    from monocon_tpu.engine import create_train_state, make_train_step
    from monocon_tpu.models.detector import MonoConDetector as JaxDetector
    from monocon_tpu.parallel import make_mesh, replicate_state, shard_batch
    from monocon_tpu.solver import build_optimizer as jax_build
    from monocon_tpu.utils.torch_convert import convert_state_dict

    data, _ = inputs
    variables = convert_state_dict({k: v.numpy()
                                    for k, v in data["state"].items()})
    with jax.enable_x64(True):
        tx = jax_build(total_steps=10, grad_accum=2)
        step = jax.jit(make_train_step(JaxDetector(34), tx))
        mesh = make_mesh(WORLD)
        state = replicate_state(
            create_train_state(jax_x64_tree(variables), tx), mesh)
        losses = []
        for batch in data["batches"]:
            jbatch = {"img": jnp.asarray(batch["img"].numpy()),
                      "label": {k: jnp.asarray(v.numpy())
                                for k, v in batch["label"].items()}}
            with mesh:
                state, out = step(state, shard_batch(jbatch, mesh))
            losses.append({k: float(v) for k, v in out.items()})
        moment = jax.tree.map(np.asarray, {
            "params": _adam_first_moment(state.opt_state),
            "batch_stats": state.batch_stats})
    return {"losses": losses, "first_moment": state_dict_from_jax(moment)}


def _close(a, b, what, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=what, **tol)


def _same_dicts(got, want, what, **tol):
    assert set(got) == set(want), what
    for key in want:
        _close(got[key], want[key], f"{what} {key}", **tol)


# ------------------------------------------------------------------ the rows
def test_rank_rows_pad_cyclically_as_the_jax_loader():
    """A remainder of 3 in a global batch of 8 over 2 ranks: rows 3-7
    repeat rows 0, 1, 2, 0, 1 (``pad_to_batch``)."""
    rows = [rank_rows(8, 3, r, 2) for r in range(2)]
    assert rows[0] == [(0, True), (1, True), (2, True), (0, False)]
    assert rows[1] == [(1, False), (2, False), (0, False), (1, False)]
    assert rank_rows(4, 4, 1, 2) == [(2, True), (3, True)]
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(6, 6, 0, 4)


def test_rank_loaders_see_what_one_loader_sees(tmp_path):
    """Two ranks' train loaders (augmentation on, global batch 4) against
    one loader over 6 images: each global batch's rows, pixels and labels
    are one loader's, the remainder of 2 padded with repeats of its rows
    and marked by ``valid`` and ``num_valid``; one loader keeps its short
    batch."""
    from monocon_tpu_torch.data.loader import DataLoader
    from monocon_tpu_torch.data.monocon_dataset import MonoConDataset
    from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
    from monocon_tpu_torch.data.transforms import default_train_transforms

    generate_kitti_dataset(str(tmp_path), num_train=6, num_val=0,
                           image_hw=(64, 160), seed=3)
    dataset = MonoConDataset(str(tmp_path), "train",
                             transforms=default_train_transforms(
                                 (48, 128), device_normalize=True))

    def batches(rank, world):
        loader = DataLoader(dataset, "cpu", batch_size=BATCH, seed=11,
                            num_workers=0, pad_hw=(64, 160), labels=True,
                            rank=rank, world=world)
        loader.set_epoch(2)
        return list(loader)

    one, ranks = batches(0, 1), [batches(r, WORLD) for r in range(WORLD)]
    assert [len(b["img"]) for b in one] == [BATCH, 2]
    for i, want in enumerate(one):
        parts = [r[i] for r in ranks]
        img = torch.cat([p["img"] for p in parts])
        valid = torch.cat([p["valid"] for p in parts])
        label = {k: torch.cat([p["label"][k] for p in parts])
                 for k in want["label"]}
        real = len(want["img"])
        assert [p["num_valid"] for p in parts] == [real] * WORLD
        assert valid.tolist() == [1.0] * real + [0.0] * (BATCH - real)
        rows = [j for r in range(WORLD)
                for j, _ in rank_rows(BATCH, real, r, WORLD)]
        assert torch.equal(img, want["img"][rows])
        for key, value in want["label"].items():
            assert torch.equal(label[key], value[rows]), key
        assert "valid" not in want


@pytest.mark.parametrize("asked, visible, batch, want", [
    (-1, 0, 8, 1), (2, 0, 8, 2), (3, 0, 8, 2), (-1, 8, 8, 8),
    (-1, 8, 12, 6), (0, 4, 8, 4), (16, 4, 8, 4)],
    ids=["cpu-all", "cpu-2", "cpu-clamped", "gpu-all", "gpu-clamped",
         "gpu-zero", "gpu-more-than-visible"])
def test_num_devices_means_every_visible_device(asked, visible, batch, want,
                                                monkeypatch):
    """``TPU.NUM_DEVICES``: -1 (or 0) is every visible GPU, as in the JAX
    package, and on the CPU one process; at most the visible GPUs; the
    count is clamped to divide ``DATA.BATCH_SIZE``."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    cfg = get_default_cfg()
    cfg.TPU.NUM_DEVICES, cfg.DATA.BATCH_SIZE = asked, batch
    device = torch.device("cuda" if visible else "cpu")
    assert num_processes(cfg, device) == want


def test_multihost_needs_torchrun_environment(monkeypatch):
    """``TPU.MULTIHOST`` outside torchrun refuses to start, rather than
    train one node alone."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    cfg = get_default_cfg()
    cfg.TPU.MULTIHOST = True
    with pytest.raises(RuntimeError, match="torchrun"):
        launch(print, cfg, torch.device("cpu"))


# ------------------------------------------------------------------- the step
def test_step_matches_jax_mesh(launched, jax_mesh, ranks):
    """Each micro-step's 11 losses, both ranks, against the JAX package's
    SPMD step on a 2-device mesh."""
    for rank in ranks:
        for got, want in zip(rank["accum"], jax_mesh["losses"]):
            assert set(got["losses"]) == set(want) and len(want) == 11
            for key in want:
                _close(got["losses"][key], want[key], key, rtol=JAX_RTOL)


def test_step_matches_one_process(ranks, one_process):
    """Losses, the averaged gradients and BN running stats of each
    micro-step equal one process's on the whole batch."""
    steps, _ = one_process["accum"]
    for rank in ranks:
        for got, want in zip(rank["accum"], steps):
            _same_dicts(got["losses"], want["losses"], "loss",
                        **PARALLEL_TOL)
    for got, want in zip(ranks[0]["accum"], steps):
        _same_dicts(got["grads"]["values"], want["grads"], "grad",
                    **PARALLEL_TOL)
        _same_dicts(got["buffers"]["values"], want["buffers"], "buffer",
                    **PARALLEL_TOL)


def _check_update(params, grads, before, lr, what):
    """The weights after AdamW's first step are its closed form on the
    gradient (held to the reference's by the caller). The weights are not
    compared with the reference's themselves: Adam's ``g / (|g| + eps)``
    turns the float32 rounding of the losses' sums into relative errors
    above 1e-6 where ``|g|`` is small (``tests/test_torch_train.py``)."""
    for name, p in params.items():
        g = grads[name].numpy()
        closed = (before[name].double().numpy() * (1 - lr * WEIGHT_DECAY)
                  - lr * g / (np.abs(g) + 1e-8))
        _close(p, closed, f"{what} {name}", **F64_TOL)


def test_accumulation_matches_multisteps(inputs, ranks, jax_mesh):
    """After the second micro-step AdamW steps on the mean gradient of the
    two global batches, as ``optax.MultiSteps`` on the mesh does."""
    data, _ = inputs
    second = ranks[0]["accum"][1]
    beta1 = second["beta1"]
    grads = second["grads"]["values"]
    for name, g in grads.items():
        g_jax = jax_mesh["first_moment"][name].numpy() / (1 - beta1)
        _close(g, g_jax, name, rtol=F64_TOL["rtol"],
               atol=F32_EPS * np.abs(g_jax).max())
    _check_update(ranks[0]["accum_params"]["values"], grads, data["state"],
                  second["lr"], "accum")


def _digests(rank):
    steps = [*rank["accum"], rank["remainder"]]
    return ([step[key]["sha256"] for step in steps
             for key in ("grads", "buffers")]
            + [rank["accum_params"]["sha256"],
               rank["remainder"]["params"]["sha256"]])


def test_ranks_hold_equal_parameters(ranks):
    """Gradients and BN buffers after each step, and the parameters at the
    end, bit for bit on both ranks (SHA-256 of their bytes)."""
    first, second = (_digests(rank) for rank in ranks)
    assert len(first) == 8 and first == second


def test_padded_remainder_matches_short_batch(inputs, ranks, one_process):
    """3 rows over 2 ranks, the fourth a masked repeat of the first: the
    step of one process on the 3 rows alone."""
    data, _ = inputs
    (want,), _ = one_process["remainder"]
    for rank in ranks:
        _same_dicts(rank["remainder"]["losses"], want["losses"], "loss",
                    **PARALLEL_TOL)
    got = ranks[0]["remainder"]
    _same_dicts(got["grads"]["values"], want["grads"], "grad",
                **PARALLEL_TOL)
    _same_dicts(got["buffers"]["values"], want["buffers"], "buffer",
                **PARALLEL_TOL)
    _check_update(got["params"]["values"], got["grads"]["values"],
                  data["state"], got["lr"], "remainder")


def test_padded_batch_matches_short_batch_on_one_device(inputs):
    """One process: the remainder padded to 4 with ``valid`` equals the
    short batch of 3 that the one-device loader gives, so that one device
    may keep the short batch."""
    data, _ = inputs
    batch = data["remainder"]
    rows = torch.tensor([j for j, _ in rank_rows(BATCH, REMAINDER, 0, 1)])
    padded = {"img": batch["img"][rows],
              "label": {k: v[rows] for k, v in batch["label"].items()},
              "valid": torch.tensor([1.0, 1.0, 1.0, 0.0],
                                    dtype=torch.float64)}
    (short,), _ = _one_process_step(data["state"], [batch], 1)
    (masked,), _ = _one_process_step(data["state"], [padded], 1)
    for key in ("losses", "grads", "buffers"):
        _same_dicts(masked[key], short[key], key, **PARALLEL_TOL)


# ------------------------------------------------------------------ BatchNorm
@pytest.mark.parametrize("case", [f"{kind}-{mode}" for kind in BN_MODULES
                                  for mode in ("full", "masked")])
def test_synced_batch_norm_matches_one_process(case, inputs, ranks):
    """Over two ranks, the module's outputs, input gradients and running
    stats equal those of the module on the valid rows of the whole batch
    (plain, unscoped), and padding rows get no gradient."""
    data, _ = inputs
    spec = data["bn"][case]
    real = spec["num_real"]
    module = BN_MODULES[spec["module"]]().double().train()
    module.load_state_dict(spec["state"])
    x = spec["x"][:real].clone().requires_grad_(True)
    out = module(x)
    (out * spec["weight"][:real]).sum().backward()

    got_out = torch.cat([r["bn"][case]["out"] for r in ranks])
    got_grad = torch.cat([r["bn"][case]["grad"] for r in ranks])
    valid = torch.cat([r["bn"][case]["valid"] for r in ranks]).bool()
    assert int(valid.sum()) == real
    _close(got_out[valid], out.detach(), "out", **F64_TOL)
    _close(got_grad[valid], x.grad, "grad", **F64_TOL)
    assert not got_grad[~valid].any()
    want = dict(module.named_buffers())
    for r in ranks:
        _same_dicts(r["bn"][case]["buffers"], want, "buffer", **F64_TOL)
