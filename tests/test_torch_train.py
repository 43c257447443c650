"""The port's training half against the JAX package, in float64: the ten
losses on shared predictions and targets, the optimizer (clip, AdamW, the
one-cycle LR and beta1) over a 20-step schedule, and one full train step
against ``make_train_step``: losses, updated params and BN running stats."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_ops_parity import random_label_batch
from tests.test_torch_decode import WIDTHS
from tests.torch_port_helpers import (F64_TOL, jax_x64_tree,
                                      perturb_variables, port_detector)

FEAT_HW, PAD_HW = (24, 80), (96, 320)
ADAM_FLAT = 1e-6
F32_EPS = float(np.finfo(np.float32).eps)


def _random_predictions_f64(rng, b):
    pred = {}
    for key, c in WIDTHS.items():
        arr = rng.normal(size=(b, *FEAT_HW, c))
        if key in ("center_heatmap_pred", "kpt_heatmap_pred"):
            arr = np.clip(1 / (1 + np.exp(-arr)), 1e-4, 1 - 1e-4)
        if key == "depth_pred":
            arr[..., 0] = np.abs(arr[..., 0]) * 20
        pred[key] = arr
    return pred


@pytest.mark.parametrize("num_valid", [(3, 7), (0, 1)])
def test_losses_match_jax_f64(num_valid, rng):
    """``(0, 1)`` leaves every mask empty: the masked losses are 0."""
    from monocon_tpu.engine import compute_losses as jax_losses
    from monocon_tpu.ops.targets import generate_targets as jax_targets
    from monocon_tpu_torch.engine.train_step import compute_losses

    label = random_label_batch(rng, b=2, o=30, feat_hw=FEAT_HW, pad_hw=PAD_HW,
                               num_valid=num_valid)
    pred = _random_predictions_f64(rng, 2)
    target = jax.tree.map(np.array, jax_targets(
        {k: jnp.asarray(v) for k, v in label.items()}, FEAT_HW, PAD_HW,
        use_pallas=False))
    with jax.enable_x64(True):
        theirs = jax_losses({k: jnp.asarray(v) for k, v in pred.items()},
                            {k: jnp.asarray(v) for k, v in target.items()})
        theirs = {k: float(v) for k, v in theirs.items()}
    ours = compute_losses({k: torch.from_numpy(v) for k, v in pred.items()},
                          {k: torch.from_numpy(v) for k, v in target.items()})
    assert set(ours) == set(theirs) and len(ours) == 10
    for key, want in theirs.items():
        assert ours[key].dtype == torch.float64, key
        np.testing.assert_allclose(float(ours[key]), want, err_msg=key,
                                   **F64_TOL)
    if num_valid == (0, 1):
        assert float(ours["loss_wh"]) == 0.0 and float(ours["loss_dim"]) == 0.0


def test_masked_losses_match_jax_f64(rng):
    """``sample_valid`` (a padded batch's last row masked): the ten losses
    against the JAX package's with the same mask, and against the port's
    on the real rows alone."""
    from monocon_tpu.engine import compute_losses as jax_losses
    from monocon_tpu.ops.targets import generate_targets as jax_targets
    from monocon_tpu_torch.engine.train_step import compute_losses

    label = random_label_batch(rng, b=3, o=30, feat_hw=FEAT_HW, pad_hw=PAD_HW)
    pred = _random_predictions_f64(rng, 3)
    target = jax.tree.map(np.array, jax_targets(
        {k: jnp.asarray(v) for k, v in label.items()}, FEAT_HW, PAD_HW,
        use_pallas=False))
    valid = np.array([1.0, 1.0, 0.0])
    with jax.enable_x64(True):
        theirs = jax_losses({k: jnp.asarray(v) for k, v in pred.items()},
                            {k: jnp.asarray(v) for k, v in target.items()},
                            sample_valid=jnp.asarray(valid))
        theirs = {k: float(v) for k, v in theirs.items()}
    torch_pred = {k: torch.from_numpy(v) for k, v in pred.items()}
    torch_target = {k: torch.from_numpy(v) for k, v in target.items()}
    ours = compute_losses(torch_pred, torch_target,
                          sample_valid=torch.from_numpy(valid))
    short = compute_losses({k: v[:2] for k, v in torch_pred.items()},
                           {k: v[:2] for k, v in torch_target.items()})
    assert set(ours) == set(theirs) and len(ours) == 10
    for key, want in theirs.items():
        np.testing.assert_allclose(float(ours[key]), want, err_msg=key,
                                   **F64_TOL)
        np.testing.assert_allclose(float(ours[key]), float(short[key]),
                                   err_msg=key, **F64_TOL)


def test_dim_loss_survives_an_exact_zero_at_padding_rows(rng):
    """The padding rows of the (B, O) table gather the dimension map at
    index 0, where a bfloat16 prediction can be exactly 0 (bfloat16
    training on an H100 went NaN that way, ROADMAP.md F3). The port
    divides the objects' rows alone, as the reference does: with 0 at
    every padding row the loss and its gradient are those with any other
    value there, and equal the JAX package's on the latter; the JAX
    formula, which divides every row, gives NaN."""
    from monocon_tpu.losses import dim_aware_l1_loss
    from monocon_tpu_torch.losses.losses import dim_aware_l1_term

    mask = np.zeros((2, 5, 1))
    mask[:, :2] = 1.0
    target = rng.uniform(1.0, 4.0, (2, 5, 3)) * mask
    pred = rng.uniform(0.5, 4.0, (2, 5, 3))
    zeroed = pred * mask
    results = []
    for p in (pred, zeroed):
        t = torch.tensor(p, requires_grad=True)
        loss = dim_aware_l1_term(t, torch.tensor(target), t,
                                 torch.tensor(mask)).value()
        loss.backward()
        assert torch.isfinite(loss) and torch.isfinite(t.grad).all()
        results.append((float(loss.detach()), t.grad.numpy() * mask))
    assert results[0][0] == results[1][0]
    np.testing.assert_array_equal(results[0][1], results[1][1])
    with jax.enable_x64(True):
        theirs = [float(dim_aware_l1_loss(jnp.asarray(p), jnp.asarray(target),
                                          jnp.asarray(p), jnp.asarray(mask)))
                  for p in (pred, zeroed)]
    np.testing.assert_allclose(results[0][0], theirs[0], **F64_TOL)
    assert np.isnan(theirs[1])


def optax_parity_over_20_steps(rng, **settings):
    """20 steps of the same gradients (some above the clip norm of 35)
    through the JAX package's optax chain and through the port's AdamW and
    :class:`Solver`, both built with ``settings``: LR, beta1 and params after
    every step."""
    import optax

    from monocon_tpu.solver import build_optimizer as jax_build
    from monocon_tpu.solver import peek_hyperparams
    from monocon_tpu_torch.solver.schedule import build_optimizer

    total, lr = 20, 2.25e-4
    shapes = {"a": (4, 3), "b": (7,)}
    init = {k: rng.normal(size=s) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s) * rng.choice([0.1, 30.0])
              for k, s in shapes.items()} for _ in range(total)]

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt, solver = build_optimizer(params.values(), lr=lr, total_steps=total,
                                  **settings)
    with jax.enable_x64(True):
        tx = jax_build(lr=lr, total_steps=total, **settings)
        jparams = {k: jnp.asarray(v) for k, v in init.items()}
        state = tx.init(jparams)
        for count, g in enumerate(grads):
            updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            hyper = peek_hyperparams(state)

            for k, p in params.items():
                p.grad = torch.from_numpy(g[k].copy())
            assert solver.step()
            group = opt.param_groups[0]
            np.testing.assert_allclose(group["lr"],
                                       float(hyper["learning_rate"]),
                                       rtol=1e-12)
            np.testing.assert_allclose(group["betas"][0], float(hyper["b1"]),
                                       rtol=1e-12)
            assert group["betas"][1] == 0.99 and group["eps"] == 1e-8
            assert solver.count == count + 1
            assert solver.current_lr == group["lr"]
            for k, p in params.items():
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jparams[k]),
                                           err_msg=f"{k} at step {count}",
                                           **F64_TOL)


def test_optimizer_matches_optax_over_20_steps(rng):
    """The default solver: clip at 35, the one-cycle schedules, weight
    decay 1e-5."""
    optax_parity_over_20_steps(rng)


def _adam_first_moment(opt_state):
    """``mu`` of the ``scale_by_adam`` state inside an optax chain."""
    for leaf in jax.tree.leaves(opt_state,
                                is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.mu
    raise AssertionError("no scale_by_adam state")


def test_train_step_matches_jax_f64(rng):
    """One step from the same weights and batch: ``make_train_step`` under
    x64 against the port's ``train_step`` on a float64 model.

    Both packages run the heads' post-ops and the losses in float32, where
    XLA and torch round ``exp``, ``log`` and ``pow`` differently, so every
    gradient carries float32 noise: at most 4.8e-8 of the largest
    ``|g|`` of its tensor in this test. So the clipped gradients (JAX's is
    read from Adam's first moment, ``(1 - b1) * g``) are held to each other
    on every element at rtol 1e-6 and an atol of float32's eps (1.2e-7)
    times that largest ``|g|``. Adam's first step,
    ``lr * g / (|g| + eps)``, passes that noise on unchanged where ``|g|``
    is large and amplifies it by up to ``lr / eps`` where ``|g|`` is near 0.
    So the updated params are held to JAX's at the float64 tolerance where
    the port's gradient is at least ``ADAM_FLAT``, and on every element to
    AdamW's closed form applied to the port's own gradient."""
    from monocon_tpu.engine import create_train_state, make_train_step
    from monocon_tpu.models import create_detector_state
    from monocon_tpu.solver import build_optimizer as jax_build
    from monocon_tpu_torch.engine.train_step import train_step
    from monocon_tpu_torch.solver.schedule import WEIGHT_DECAY, build_optimizer
    from monocon_tpu_torch.utils.weights import state_dict_from_jax

    hw = (64, 160)
    model, variables = create_detector_state(jax.random.PRNGKey(0),
                                             image_hw=hw)
    variables = perturb_variables(variables, rng)
    label = random_label_batch(rng, b=2, o=30, feat_hw=(16, 40), pad_hw=hw)
    img = rng.normal(size=(2, *hw, 3))

    with jax.enable_x64(True):
        tx = jax_build(total_steps=10)
        state = create_train_state(jax_x64_tree(variables), tx)
        batch = {"img": jnp.asarray(img, jnp.float64),
                 "label": {k: jnp.asarray(v) for k, v in label.items()}}
        new_state, theirs = jax.jit(make_train_step(model, tx))(state, batch)
        theirs = {k: float(v) for k, v in theirs.items()}
        expected = state_dict_from_jax(jax.tree.map(np.asarray, {
            "params": new_state.params, "batch_stats": new_state.batch_stats}))
        first_moment = state_dict_from_jax(jax.tree.map(np.asarray, {
            "params": _adam_first_moment(new_state.opt_state),
            "batch_stats": new_state.batch_stats}))

    port = port_detector(variables, torch.float64)
    opt, sched = build_optimizer(port.parameters(), total_steps=10)
    ours = train_step(port, opt, sched, {
        "img": torch.from_numpy(img),
        "label": {k: torch.from_numpy(v) for k, v in label.items()}})
    assert set(ours) == set(theirs) and len(ours) == 11
    for key, want in theirs.items():
        np.testing.assert_allclose(float(ours[key]), want, err_msg=key,
                                   **F64_TOL)

    got = port.state_dict()
    stats = [k for k in expected if "running_" in k]
    assert set(got) == set(expected) and len(stats) > 100
    for key in stats:
        np.testing.assert_allclose(got[key].numpy(), expected[key].numpy(),
                                   err_msg=key, **F64_TOL)
    assert all(int(v) == 1 for k, v in got.items()
               if k.endswith("num_batches_tracked"))

    group = opt.param_groups[0]
    lr, beta1, eps = group["lr"], group["betas"][0], group["eps"]
    before = state_dict_from_jax(variables)
    for name, p in port.named_parameters():
        ours_p, want = got[name].numpy(), expected[name].numpy()
        g = p.grad.numpy()
        g_jax = first_moment[name].numpy() / (1 - beta1)
        np.testing.assert_allclose(g, g_jax, rtol=F64_TOL["rtol"],
                                   atol=F32_EPS * np.abs(g_jax).max(),
                                   err_msg=name)
        closed_form = (before[name].numpy() * (1 - lr * WEIGHT_DECAY)
                       - lr * g / (np.abs(g) + eps))
        np.testing.assert_allclose(ours_p, closed_form, err_msg=name,
                                   **F64_TOL)
        steep = np.abs(g) >= ADAM_FLAT
        np.testing.assert_allclose(ours_p[steep], want[steep], err_msg=name,
                                   **F64_TOL)
        # Weight decay reaches every parameter, those with no gradient too.
        assert not np.array_equal(ours_p, before[name].numpy()), name
