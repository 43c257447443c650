"""The port's solver against optax in float64: the solver settings over 20
steps, gradient accumulation against ``optax.MultiSteps`` on a small
parameter tree, and one accumulated DLA-34 train step (k=2, two different
micro-batches) against ``make_train_step`` with the JAX package's
``MultiSteps`` optimizer."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monocon_tpu.engine import create_train_state, make_train_step
from monocon_tpu.models.detector import MonoConDetector as JaxDetector
from monocon_tpu.solver import build_optimizer as jax_build
from monocon_tpu.solver import peek_hyperparams
from monocon_tpu.utils.torch_convert import convert_state_dict
from monocon_tpu_torch.engine.train_step import train_step
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.solver.schedule import build_optimizer
from monocon_tpu_torch.utils.weights import state_dict_from_jax
from test_ops_parity import random_label_batch
from test_torch_train import (F32_EPS, _adam_first_moment,
                              optax_parity_over_20_steps)
from torch_port_helpers import (F64_TOL, jax_x64_tree, perturb_variables,
                                port_detector)

HW = (64, 96)


@pytest.mark.parametrize("settings", [
    {"use_scheduler": False},
    {"clip_grad_norm": None},
    {"clip_grad_norm": 10.0},
    {"weight_decay": 1e-4},
], ids=["no_scheduler", "no_clip", "clip_10", "weight_decay_1e-4"])
def test_solver_settings_match_optax_over_20_steps(settings, rng):
    """LR, beta1 and params after each of 20 steps, as in
    ``test_torch_train.py`` for the default settings. Without the scheduler
    the LR stays at the base LR and beta1 at 0.95."""
    optax_parity_over_20_steps(rng, **settings)


def test_accumulation_matches_multisteps_over_12_micro_steps(rng):
    """k=3 on 12 micro-steps of different gradients, some above the clip
    norm: after every micro-step the params equal optax's at the float64
    tolerance, and bit for bit the params before it unless the micro-step
    completed an accumulation; the step count, micro-step index and LR
    follow ``MultiSteps``' state."""
    total, lr, k = 4, 2.25e-4, 3
    shapes = {"a": (4, 3), "b": (7,)}
    init = {n: rng.normal(size=s) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s) * rng.choice([0.1, 30.0])
              for n, s in shapes.items()} for _ in range(total * k)]
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt, solver = build_optimizer(params.values(), lr=lr, total_steps=total,
                                  grad_accum=k)
    with jax.enable_x64(True):
        tx = jax_build(lr=lr, total_steps=total, grad_accum=k)
        jparams = {n: jnp.asarray(v) for n, v in init.items()}
        state = tx.init(jparams)
        for i, g in enumerate(grads):
            updates, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                       state, jparams)
            jparams = optax.apply_updates(jparams, updates)

            before = {n: p.detach().clone() for n, p in params.items()}
            for n, p in params.items():
                p.grad = torch.from_numpy(g[n].copy())
            stepped = solver.step()
            assert stepped == ((i + 1) % k == 0), i
            assert solver.count == int(state.gradient_step) == (i + 1) // k
            assert solver.mini_step == int(state.mini_step) == (i + 1) % k
            np.testing.assert_allclose(
                solver.current_lr,
                float(peek_hyperparams(state)["learning_rate"]), rtol=1e-12)
            for n, p in params.items():
                if not stepped:
                    assert torch.equal(p.detach(), before[n]), (n, i)
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jparams[n]),
                                           err_msg=f"{n} at micro-step {i}",
                                           **F64_TOL)


def test_accumulated_train_step_matches_multisteps_f64(rng):
    """Two micro-steps (k=2) on two different batches from the same
    weights: ``make_train_step`` with the JAX package's ``MultiSteps``
    optimizer under x64 against the port's ``train_step`` on a float64
    model.

    * micro-step 1: the losses and BN running stats agree at the float64
      tolerance; the port's params are bit-unchanged, and so are JAX's;
      no optimizer step is counted;
    * micro-step 2: losses and BN stats as before; the clipped mean
      gradient, the updated params and their AdamW closed form at the
      tolerances of ``test_torch_train.py::test_train_step_matches_jax_f64``
      (float32 noise in both packages' heads and losses, amplified by
      Adam's first step where a gradient is near 0); one optimizer step."""
    model = create_detector(34, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    variables = perturb_variables(convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}), rng)
    batches = []
    for _ in range(2):
        label = random_label_batch(rng, b=2, o=30,
                                   feat_hw=(HW[0] // 4, HW[1] // 4), pad_hw=HW)
        batches.append((rng.normal(size=(2, *HW, 3)), label))

    with jax.enable_x64(True):
        tx = jax_build(total_steps=10, grad_accum=2)
        state = create_train_state(jax_x64_tree(variables), tx)
        step = jax.jit(make_train_step(JaxDetector(34), tx))
        theirs = []
        for img, label in batches:
            before = jax.tree.map(np.asarray, state.params)
            state, losses = step(state, {
                "img": jnp.asarray(img, jnp.float64),
                "label": {k: jnp.asarray(v) for k, v in label.items()}})
            after = jax.tree.map(np.asarray, {
                "params": state.params, "batch_stats": state.batch_stats})
            theirs.append(({k: float(v) for k, v in losses.items()},
                           state_dict_from_jax(after),
                           all(np.array_equal(a, b) for a, b in zip(
                               jax.tree.leaves(before),
                               jax.tree.leaves(after["params"]))),
                           int(state.opt_state.gradient_step)))
        first_moment = state_dict_from_jax(jax.tree.map(np.asarray, {
            "params": _adam_first_moment(state.opt_state),
            "batch_stats": state.batch_stats}))

    port = port_detector(variables, torch.float64)
    opt, solver = build_optimizer(port.parameters(), total_steps=10,
                                  grad_accum=2)
    initial = {k: v.clone() for k, v in port.state_dict().items()}
    for i, ((img, label), (want, expected, unchanged, count)) in enumerate(
            zip(batches, theirs)):
        ours = train_step(port, opt, solver, {
            "img": torch.from_numpy(img),
            "label": {k: torch.from_numpy(v) for k, v in label.items()}})
        assert set(ours) == set(want) and len(ours) == 11
        for key, value in want.items():
            np.testing.assert_allclose(float(ours[key]), value,
                                       err_msg=f"micro-step {i} {key}",
                                       **F64_TOL)
        got = port.state_dict()
        stats = [k for k in expected if "running_" in k]
        assert len(stats) > 100
        for key in stats:
            np.testing.assert_allclose(got[key].numpy(),
                                       expected[key].numpy(),
                                       err_msg=f"micro-step {i} {key}",
                                       **F64_TOL)
        assert solver.count == count == i
        assert unchanged == (i == 0)
        if i == 0:
            for name, _ in port.named_parameters():
                assert torch.equal(got[name], initial[name]), name
            assert not opt.state

    group = opt.param_groups[0]
    lr, beta1, eps = group["lr"], group["betas"][0], group["eps"]
    weight_decay = group["weight_decay"]
    checked = total = 0
    for name, p in port.named_parameters():
        ours_p, want = got[name].numpy(), expected[name].numpy()
        g = p.grad.numpy()
        g_jax = first_moment[name].numpy() / (1 - beta1)
        np.testing.assert_allclose(g, g_jax, rtol=F64_TOL["rtol"],
                                   atol=F32_EPS * np.abs(g_jax).max(),
                                   err_msg=name)
        closed_form = (initial[name].numpy() * (1 - lr * weight_decay)
                       - lr * g / (np.abs(g) + eps))
        np.testing.assert_allclose(ours_p, closed_form, err_msg=name,
                                   **F64_TOL)
        # Adam's first step moves a weight by lr * g / (|g| + eps): the
        # float32 noise that the gradient check allows, F32_EPS * max|g|,
        # reaches the weight times lr * eps / (|g| + eps)**2. Held at the
        # float64 tolerance where that stays within its atol (|g| above
        # about 1e-5 here; the one-step test's ADAM_FLAT of 1e-6 leaves 1
        # or 2 weights of this step at 2e-3 relative noise in g).
        noise = F32_EPS * np.abs(g_jax).max()
        steep = lr * eps * noise / (np.abs(g) + eps) ** 2 <= F64_TOL["atol"]
        checked, total = checked + int(steep.sum()), total + steep.size
        np.testing.assert_allclose(ours_p[steep], want[steep], err_msg=name,
                                   **F64_TOL)
    print(f"{checked} of {total} weights held to JAX's at the float64 "
          "tolerance")
    assert checked > 0.9 * total
