"""One rank of the port's spatial checks on the CPU (gloo), for
``tests/test_torch_spatial*.py``.

Run with torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and two arguments: the inputs file the
test wrote (``state``, ``img`` and ``label`` of the real rows,
``batch_size``, ``spatial``) and
the file this rank writes its results to. The group's ranks form
``WORLD_SIZE // spatial`` data shards of ``spatial`` bands of the canvas
height (``parallel/mesh.py::spatial_layout``). In float64, each rank runs:

  * ``gradcheck``: ``torch.autograd.gradcheck`` of a halo exchange of
    uneven bands followed by a row gather, as a function of the whole
    tensor that every rank holds;
  * ``eval``: the detector's eval forward on its band of its data shard's
    rows: the gathered head maps, and the height of every 4D output of
    the backbone's and the neck's modules with the width it came with;
  * ``step``: one train step of the detector under ``data_parallel`` on
    its band of its rows (a padded remainder masked by ``valid``): the
    losses, and the gradients, BN buffers and parameters after it.

The gradients, buffers and parameters are the same on every rank: rank 0
writes them, and every rank writes a SHA-256 of each set's bytes.
"""

import sys

import torch
import torch.distributed as dist

from monocon_tpu_torch.engine.train_step import train_step
from monocon_tpu_torch.models.detector import create_detector
from monocon_tpu_torch.parallel import (HaloExchange, data_parallel,
                                        gather_rows, initialize_distributed,
                                        spatial_layout, spatial_scope)
from monocon_tpu_torch.parallel.spatial import GatherRows
from monocon_tpu_torch.solver.schedule import build_optimizer
from torch_parallel_worker import my_rows, tensors

# Halo rows above and below in the gradcheck.
GRADCHECK_HALO = (2, 1)


class SumOfPartials(torch.autograd.Function):
    """The identity on a tensor that every rank of ``group`` holds alike;
    its gradient is the sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gradcheck(layout):
    """gradcheck of halo exchange + row gather over the space group, each
    band ``2 + s`` rows high, with a 4x1 check of ``gather_rows``' row
    sizes at the stride of the layout's own bands."""
    s, spatial = layout.space_index, layout.spatial
    sizes = [2 + i for i in range(spatial)]
    start = sum(sizes[:s])
    top, bottom = GRADCHECK_HALO
    x = torch.randn(2, 3, sum(sizes), 4, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5),
                    requires_grad=True)

    def whole(x):
        band = SumOfPartials.apply(x, layout.space_group)[
            :, :, start:start + sizes[s]]
        rows = HaloExchange.apply(band, top, bottom, layout).permute(
            0, 2, 1, 3)
        return GatherRows.apply(rows.contiguous(),
                                [n + top + bottom for n in sizes], layout)

    ok = torch.autograd.gradcheck(whole, (x,), eps=1e-6, atol=1e-8)
    # gather_rows reads each band's rows at a map's stride off the layout.
    a, b = layout.band
    quarter = torch.full((1, (b - a) // 4, 2, 1), float(s))
    got = gather_rows(quarter, layout)
    want = torch.cat([torch.full((1, (hi - lo) // 4, 2, 1), float(i))
                      for i, (lo, hi) in enumerate(layout.bands)], 1)
    return {"gradcheck": ok, "gather_rows": torch.equal(got, want)}


def output_heights(model):
    """Forward hooks on every module of the backbone and the neck that
    record (height, width) of each 4D output."""
    seen, handles = [], []

    def hook(module, args, out):
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dim() == 4:
                seen.append((t.shape[2], t.shape[3]))

    for part in (model.backbone, model.neck):
        for m in part.modules():
            handles.append(m.register_forward_hook(hook))
    return seen, handles


def main(inputs_path, out_path):
    torch.set_num_threads(1)
    device = initialize_distributed("cpu")
    inputs = torch.load(inputs_path, weights_only=False)
    img = inputs["img"]
    layout = spatial_layout(img.shape[1], inputs["spatial"])
    rank = dist.get_rank()
    out = {"data_index": layout.data_index, "space_index":
           layout.space_index, "band": layout.band,
           **gradcheck(layout)}

    rows, valid = my_rows({"img": img, "label": inputs["label"]},
                          inputs["batch_size"], len(img), layout.data_index,
                          layout.data_shards)
    band = rows["img"][:, slice(*layout.band)]
    model = create_detector(device=device).to_memory_format(
        inputs.get("memory_format", torch.channels_last))
    model.load_state_dict(inputs["state"])
    model = model.double().eval()
    seen, handles = output_heights(model)
    with torch.no_grad(), spatial_scope(model, layout):
        out["eval"] = model(band)
    for h in handles:
        h.remove()
    out["heights"] = seen
    out["valid"] = valid

    ddp = data_parallel(model, device)
    optimizer, solver = build_optimizer(ddp.parameters(), total_steps=10)
    batch = {"img": band, "label": rows["label"]}
    if layout.data_shards > 1:
        batch["valid"] = valid
    losses = train_step(ddp, optimizer, solver, batch, layout)
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["grads"] = tensors(((k, p.grad) for k, p in model.named_parameters()),
                           rank)
    out["buffers"] = tensors(model.named_buffers(), rank)
    out["params"] = tensors(model.named_parameters(), rank)
    torch.save(out, out_path)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
