"""The overfit check in the JAX package beside the port, on the CPU, from the
same initial weights and the same tree: the witness of F3 (``ROADMAP.md``
section 3).

    python tests/jax_overfit_witness.py jax|port STEPS H W --out FILE
        [--tree DIR] [--objects-only-dim]
    python tests/jax_overfit_witness.py grads H W [--tree DIR]

Both sides build the run as ``scripts/overfit_check.py`` does: the JAX
generator's tree (4 train images, seed 21) at H x W, written under
``--tree`` unless it is there, one batch of 4 (Normalize, Pad(32)), the
JAX package's detector from ``PRNGKey(0)`` (the port loads it through
``state_dict_from_jax``), the one-cycle AdamW at LR 5e-4 over STEPS
steps, in bfloat16. Every 100 steps, and at the last, a JSON line with
``overfit_breakdown.py``'s keys: the center-heatmap and total losses,
the share of the objects' rows with a predicted dimension below 0, the
share of their entries below 0 and the smallest, and the gradient's
global norm before the clip; the JAX side adds ``pad_zero_steps``, the
steps so far at which a padding row of the dimension loss read a
prediction of exactly 0 (where the JAX package's ``dim_aware_l1_loss``,
dividing every row, gives NaN). ``--objects-only-dim`` runs the JAX
side with that loss dividing the objects' rows alone, as the port and
the reference do (a patch of the imported function in this process; the
package's files are not touched). The port's side runs
``overfit_breakdown.breakdown_run`` on the CPU.

``grads`` prints the first step's gradient norm per parameter group
(backbone levels, neck, AttnBatchNorm, each head) of both packages in
float32 and bfloat16, and their global norms.

The JAX step at 192x640 takes about 3.4 s on an 8-core CPU: 4000 steps
take about four hours.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from monocon_tpu.data import DataLoader, MonoConDataset  # noqa: E402
from monocon_tpu.data.synthetic import generate_kitti_dataset  # noqa: E402
from monocon_tpu.data.transforms import Normalize, Pad  # noqa: E402
from monocon_tpu.engine import create_train_state  # noqa: E402
from monocon_tpu.engine import train_step as jax_train_step  # noqa: E402
from monocon_tpu.losses.losses import _masked_mean  # noqa: E402
from monocon_tpu.models import create_detector_state  # noqa: E402
from monocon_tpu.ops.heatmap import gather_feature  # noqa: E402
from monocon_tpu.ops.image_norm import normalize_if_raw  # noqa: E402
from monocon_tpu.ops.targets import generate_targets  # noqa: E402
from monocon_tpu.solver import build_optimizer  # noqa: E402
from monocon_tpu_torch.models.detector import create_detector  # noqa: E402
from monocon_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

LR = 5e-4
EVERY = 100


def objects_only_dim_loss():
    """Make the JAX step's dimension loss divide the objects' rows alone."""
    def dim_aware_l1_loss(pred, target, dims, mask):
        dims = jax.lax.stop_gradient(dims)
        diff = jnp.abs(pred - target)
        rows = jnp.broadcast_to(mask, diff.shape) > 0
        loss = diff / jnp.where(rows, dims, 1.0)
        l1_mean = _masked_mean(diff, mask)
        loss_mean = _masked_mean(loss, mask)
        compensation = jax.lax.stop_gradient(
            jnp.where(loss_mean == 0, 1.0, l1_mean / loss_mean))
        return _masked_mean(loss * compensation, mask)

    jax_train_step.dim_aware_l1_loss = dim_aware_l1_loss


def tree_and_batch(tree, hw):
    if not (Path(tree) / "ImageSets").exists():
        generate_kitti_dataset(tree, num_train=4, num_val=4, image_hw=hw,
                               seed=21)
    dataset = MonoConDataset(tree, "train",
                             transforms=[Normalize(), Pad(32)])
    batch = next(iter(DataLoader(dataset, batch_size=4, shuffle=False,
                                 num_workers=2, pad_hw=hw, seed=0)))
    return {"img": jnp.asarray(batch["img"]),
            "label": {k: jnp.asarray(v) for k, v in batch["label"].items()}}


def jax_run(args, hw, emit):
    model, variables = create_detector_state(
        jax.random.PRNGKey(0), image_hw=hw,
        dtype=jnp.bfloat16)
    batch = tree_and_batch(args.tree, hw)
    opt = build_optimizer(lr=LR, total_steps=args.steps, use_scheduler=True)

    def step(state, batch):
        img = normalize_if_raw(batch["img"], batch.get("img_hw"))
        feat_hw = (img.shape[1] // 4, img.shape[2] // 4)
        target = generate_targets(batch["label"], feat_hw, img.shape[1:3],
                                  use_pallas=False)

        def loss_fn(params):
            pred, new = model.apply(
                {"params": params, "batch_stats": state.batch_stats}, img,
                train=True, mutable=["batch_stats"])
            losses = jax_train_step.compute_losses(pred, target)
            return sum(losses.values()), (losses, new["batch_stats"],
                                          pred["dim_pred"])

        (total, (losses, stats, dim)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        losses["total_loss"] = total
        dims = gather_feature(dim, target["indices"])
        rows = target["mask_target"] > 0
        aux = {"neg_dim_rows": jnp.sum(jnp.any(dims < 0, -1) & rows)
               / jnp.sum(rows),
               "neg_dims": jnp.sum((dims < 0) & rows[..., None])
               / (3 * jnp.sum(rows)),
               "min_dim": jnp.min(jnp.where(rows[..., None], dims, jnp.inf)),
               "grad_norm": optax.global_norm(grads),
               "pad_zero": jnp.any((dims == 0) & ~rows[..., None])}
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             batch_stats=stats, opt_state=opt_state,
                             step=state.step + 1), losses, aux

    step = jax.jit(step, donate_argnums=0)
    state = create_train_state(variables, opt)
    run, pad_zero, t0 = f"jax bfloat16 {hw[0]}x{hw[1]} {args.steps}", 0, \
        time.perf_counter()
    for i in range(args.steps):
        state, losses, aux = step(state, batch)
        pad_zero += bool(aux["pad_zero"])
        if i % EVERY == 0 or i == args.steps - 1:
            emit({"run": run, "step": i,
                  "loss_center_heatmap": float(losses["loss_center_heatmap"]),
                  "total_loss": float(losses["total_loss"]),
                  **{k: float(aux[k]) for k in ("neg_dim_rows", "neg_dims",
                                                "min_dim", "grad_norm")},
                  "pad_zero_steps": pad_zero,
                  "s": time.perf_counter() - t0})
    emit({"run": run, "final": {k: float(v) for k, v in losses.items()}})


def port_run(args, hw, emit):
    import overfit_breakdown

    tree_and_batch(args.tree, hw)
    _, variables = create_detector_state(jax.random.PRNGKey(0), image_hw=hw)
    model = create_detector(device="cpu", compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables)))
    overfit_breakdown.breakdown_run(
        args.steps, "bfloat16", hw, torch.device("cpu"), EVERY, model,
        lambda line: emit({**json.loads(line), "run": "port " + json.loads(
            line)["run"]}), args.tree)


def grads(args, hw):
    """The first step's gradient of both packages, per parameter group."""
    from monocon_tpu_torch.checks.overfit import overfit_batch
    from test_torch_bf16 import (DTYPES, JaxDetector, _jax_grads, grad_group,
                                 port_grads)

    batch = tree_and_batch(args.tree, hw)
    _, variables = create_detector_state(jax.random.PRNGKey(0), image_hw=hw)
    variables = jax.tree.map(np.asarray, variables)
    norms = {}
    for name, dtype in DTYPES.items():
        g = jax.jit(_jax_grads, static_argnums=0)(
            JaxDetector(34, dtype=dtype), variables, batch["img"],
            batch["label"])
        g = state_dict_from_jax({"params": jax.tree.map(np.asarray, g),
                                 "batch_stats": variables["batch_stats"]})
        model = create_detector(device="cpu", compute_dtype=(
            torch.bfloat16 if name == "bf16" else torch.float32))
        model.load_state_dict(state_dict_from_jax(variables))
        ours = port_grads(model, overfit_batch(args.tree, torch.device("cpu"),
                                               hw)[2])
        for key, value in ours.items():
            group = norms.setdefault(grad_group(key), {})
            for side, grad in (("jax", g[key]), ("port", value)):
                k = f"{side} {name}"
                group[k] = group.get(k, 0.0) + float(
                    (grad.double() ** 2).sum())
    total = {}
    for group, parts in norms.items():
        print(f"{group:30s}" + "".join(f"  {k} {v ** 0.5:10.3f}"
                                       for k, v in sorted(parts.items())))
        for k, v in parts.items():
            total[k] = total.get(k, 0.0) + v
    print(json.dumps({k: v ** 0.5 for k, v in sorted(total.items())}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("which", choices=("jax", "port", "grads"))
    parser.add_argument("steps", type=int, nargs="?", default=1)
    parser.add_argument("h", type=int)
    parser.add_argument("w", type=int)
    parser.add_argument("--out", default=None)
    parser.add_argument("--tree", default=None)
    parser.add_argument("--objects-only-dim", action="store_true")
    args = parser.parse_args()
    hw = (args.h, args.w)
    args.tree = args.tree or str(ROOT / "build" / f"witness_tree_{hw[0]}x"
                                 f"{hw[1]}")
    if args.which == "grads":
        return grads(args, hw)
    if args.objects_only_dim:
        objects_only_dim_loss()
    out = open(args.out, "w") if args.out else None

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    (jax_run if args.which == "jax" else port_run)(args, hw, emit)


if __name__ == "__main__":
    main()
