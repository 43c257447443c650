"""One rank of the port's data-parallel checks on the CPU (gloo), for
``tests/test_torch_parallel.py``.

Run with torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and two arguments: the ``inputs.pt`` the
test wrote and the file this rank writes its results to. Every check runs
in float64 on this rank's rows of each global batch:

  * ``bn``: each BatchNorm case of the inputs under ``batch_stats_scope``
    over the group: outputs, input gradients of a weighted sum of the
    valid rows, running stats;
  * ``accum``: the DLA-34 detector under ``data_parallel`` with gradient
    accumulation k=2, two micro-steps on two global batches: per
    micro-step the losses, the parameters' gradients after the step and
    the BN running stats, and the parameters at the end;
  * ``remainder``: a fresh detector, one step on a global batch of 3 rows
    padded to 4 (k=1): losses, gradients, running stats, parameters.

The gradients, buffers and parameters are the same on every rank: rank 0
writes them, and every rank writes a SHA-256 of each set's bytes.
"""

import hashlib
import sys

import torch

from monocon_tpu_torch.engine.train_step import train_step
from monocon_tpu_torch.models import layers
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.parallel import (data_parallel, initialize_distributed,
                                        rank_and_world, rank_rows)
from monocon_tpu_torch.solver.schedule import build_optimizer

BN_MODULES = {
    "batch_norm": lambda: layers.batch_norm(8),
    "moments": lambda: layers.MomentsBatchNorm(4, eps=layers.BN_EPS,
                                               momentum=layers.BN_MOMENTUM),
    "attn": lambda: layers.AttnBatchNorm(8),
}


def my_rows(tree, size, num_real, rank, world):
    """(this rank's rows of every tensor in a dict nest, their valid 0/1),
    of a global batch of ``size`` rows, the first ``num_real`` real."""
    rows = rank_rows(size, num_real, rank, world)
    index = torch.tensor([j for j, _ in rows])
    valid = torch.tensor([float(v) for _, v in rows], dtype=torch.float64)

    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[index]

    return take(tree), valid


def bn_case(case, rank, world):
    module = BN_MODULES[case["module"]]().double().train()
    module.load_state_dict(case["state"])
    rows, valid = my_rows({"x": case["x"], "w": case["weight"]},
                          len(case["x"]), case["num_real"], rank, world)
    x = rows["x"].clone().requires_grad_(True)
    with layers.batch_stats_scope(module, torch.distributed.group.WORLD,
                                  valid):
        out = module(x)
    (out * rows["w"] * valid.reshape(-1, *[1] * (out.ndim - 1))).sum() \
        .backward()
    return {"out": out.detach(), "grad": x.grad, "valid": valid,
            "buffers": {k: v.clone() for k, v in module.named_buffers()}}


def detector(state, device):
    model = create_detector(device=device)
    model.load_state_dict(state)
    return data_parallel(model.double(), device)


def tensors(named, rank):
    """{"sha256": digest of the tensors' bytes, "values": the tensors on
    rank 0}."""
    values = {k: v.detach().clone() for k, v in named}
    digest = hashlib.sha256()
    for v in values.values():
        digest.update(v.numpy().tobytes())
    return {"sha256": digest.hexdigest(),
            "values": values if rank == 0 else None}


def step(model, optimizer, solver, batch, size, num_real, rank, world):
    rows, valid = my_rows({"img": batch["img"], "label": batch["label"]},
                          size, num_real, rank, world)
    losses = train_step(model, optimizer, solver, {**rows, "valid": valid})
    module = model.module
    return {
        "losses": {k: float(v) for k, v in losses.items()},
        "grads": tensors(((k, p.grad) for k, p in module.named_parameters()),
                         rank),
        "buffers": tensors(module.named_buffers(), rank),
        "lr": optimizer.param_groups[0]["lr"],
        "beta1": optimizer.param_groups[0]["betas"][0],
    }


def main(inputs_path, out_path):
    torch.set_num_threads(1)
    device = initialize_distributed("cpu")
    rank, world = rank_and_world()
    inputs = torch.load(inputs_path, weights_only=False)
    out = {"bn": {name: bn_case(case, rank, world)
                  for name, case in inputs["bn"].items()}}

    model = detector(inputs["state"], device)
    optimizer, solver = build_optimizer(model.parameters(), total_steps=10,
                                        grad_accum=2)
    out["accum"] = [step(model, optimizer, solver, batch, len(batch["img"]),
                         len(batch["img"]), rank, world)
                    for batch in inputs["batches"]]
    out["accum_params"] = tensors(model.module.named_parameters(), rank)

    model = detector(inputs["state"], device)
    optimizer, solver = build_optimizer(model.parameters(), total_steps=10)
    out["remainder"] = step(model, optimizer, solver, inputs["remainder"],
                            inputs["batch_size"],
                            len(inputs["remainder"]["img"]), rank, world)
    out["remainder"]["params"] = tensors(model.module.named_parameters(),
                                         rank)
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
