"""The comparison that decides ``correct``: the program's first three
training steps against the plain reference's, on batches the reference
makes itself from the tree and the seed.

Numbers compared (each against the configuration's ``limits``):

``batch_diff``
    Elements of the three batches (the uint8 canvas, ``img_hw``, ``p2``
    and every label array) where the program's loader and the reference
    disagree; exact, limit 0.
``loss_gap1``
    |program - reference| / |reference| of the first step's total loss
    (``loss_gap``: the largest of the three steps').
``term_gap``
    The first step's worst loss term of the ten, by the same measure.
``grad_gap``
    The first gradient as AdamW got it, by the worst leaf: the gap between
    the program's norm of a leaf and the reference's, over the larger of
    the reference's norm of that leaf and its median leaf's norm.
``update_gap``
    The parameters' change over the three steps, by the worst leaf, as
    above.

Leaves whose reference gradient is under a thousandth of the median
leaf's count in neither gradient nor change: their moves under AdamW are
rounding (in DLA-34, the ``project`` convolutions that no path uses).

The reference put in the program's place (``train_check``'s
``control``) reads each number the same way: computed in the precision
below the configuration's (``tf32``), or with one of ``FAULTS`` planted.

The reference model is the configuration's own: its ``"reference"`` key
names a file of ``perfbench/reference/`` (:func:`reference_module`) that
gives ``build(model, precision)``, the model of the configuration's
``"model"`` dict, and ``backends(precision)``, the context it computes
in; it may name the convolution the ``conv2`` fault mirrors
(``FAULT_CONV``). Such a file may import the other reference files, and
never the program, JAX or the JAX package (:func:`refused_imports`).
"""

from __future__ import annotations

import ast
import importlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .reference import data as ref_data
from .reference.step import AdamW, train_step

HERE = Path(__file__).resolve().parent
NEGLIGIBLE = 1e-3
REFERENCE_PACKAGE = f"{__package__}.reference"
# Top-level modules a reference may not import: JAX, the JAX package and
# the program. Of the benchmark's own modules it may import only
# ``perfbench.reference``'s, since the others drive the program.
NOT_FOR_REFERENCE = ("jax", "jaxlib", "flax", "monocon_tpu",
                     "monocon_tpu_torch")
DEFAULT_FAULT_CONV = "backbone.level5.tree2.conv2"


def _imported(path: Path) -> List[str]:
    """The modules a Python file imports, relative ones resolved as in
    ``perfbench.reference``; of ``from m import a``, both ``m`` and
    ``m.a``."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            package = (REFERENCE_PACKAGE.rsplit(".", node.level - 1)[0]
                       if node.level else "")
            base = ".".join(filter(None, (package, node.module)))
            names += [base] + [f"{base}.{a.name}" for a in node.names]
    return names


def refused_imports(path: Path, seen: Optional[set] = None) -> List[str]:
    """What a reference file, and the reference files it imports, import
    that a reference may not (``NOT_FOR_REFERENCE``, or a module of the
    benchmark outside ``perfbench.reference``)."""
    seen = set() if seen is None else seen
    seen.add(path)
    out = []
    for name in _imported(path):
        top = name.split(".")[0]
        in_reference = f"{name}.".startswith(f"{REFERENCE_PACKAGE}.")
        if top in NOT_FOR_REFERENCE or (top == __package__
                                        and not in_reference):
            out.append(f"{path.name} imports {name}")
        elif in_reference and name != REFERENCE_PACKAGE:
            dep = path.parent / f"{name.split('.')[2]}.py"
            if dep.is_file() and dep not in seen:
                out += refused_imports(dep, seen)
    return out


def reference_module(config: Dict):
    """The module of the configuration's ``"reference"`` file, a file of
    ``perfbench/reference/`` named by its path from the checkout's root;
    refused (ValueError) where it lies elsewhere or imports what a
    reference may not."""
    path = (HERE.parent / config["reference"]).resolve()
    if path.parent != HERE / "reference" or not (
            path.suffix == ".py" and path.is_file()):
        raise ValueError(f"{config['name']}: the reference "
                         f"{config['reference']} is no file of "
                         "perfbench/reference/")
    refused = refused_imports(path)
    if refused:
        raise ValueError(f"{config['name']}: a reference may import "
                         "neither the program, JAX nor the harness: "
                         f"{'; '.join(refused)}")
    return importlib.import_module(f"{REFERENCE_PACKAGE}.{path.stem}")


def reference_batches(record: Dict, config: Dict, augment: bool
                      ) -> List[Dict[str, np.ndarray]]:
    """The checked batches as the reference makes them."""
    root, split, seed = record["root"], record["split"], record["seed"]
    ids = ref_data.split_ids(root, split)
    out = []
    for b in record["batches"]:
        order = ref_data.epoch_order(len(ids), seed, b["epoch"], shuffle=True)
        pos = b["positions"]
        out.append(ref_data.make_batch(
            root, [ids[i] for i in order[pos]], seed, b["epoch"], pos,
            augment, tuple(config["cfg"]["DATA.CROP_HW"]),
            tuple(config["cfg"]["TPU.PAD_HW"])))
    return out


def batch_diff(program: Dict, reference: Dict) -> int:
    """Elements where two batches differ (every array, labels included)."""
    count = 0
    for key in ("img", "img_hw", "p2"):
        a = np.asarray(program[key])
        b = np.asarray(reference[key])
        count += a.size if a.shape != b.shape else int((a != b).sum())
    for key, b in reference["label"].items():
        a = np.asarray(program["label"][key], np.float32)
        count += b.size if a.shape != b.shape else int((a != b).sum())
    return count


def _to(batch: Dict, device) -> Dict:
    if isinstance(batch, dict):
        return {k: _to(v, device) for k, v in batch.items()}
    return torch.as_tensor(np.asarray(batch)).to(device)


def half_batches(batches: List[Dict]) -> List[Dict]:
    """The fault of a step that leaves out half of its batch and takes the
    mean over the rest: the first half of every batch's rows."""
    def first_half(tree):
        if isinstance(tree, dict):
            return {k: first_half(v) for k, v in tree.items()}
        return tree[:len(tree) // 2]
    return [first_half(b) for b in batches]


def flipped_conv2(model: torch.nn.Module, name: str) -> None:
    """The fault of a convolution kernel applied mirrored: the convolution
    ``name`` (by default the last residual block's middle one,
    ``backbone.level5.tree2.conv2``, in either DLA depth) computes with its
    kernel rotated by 180 degrees."""
    conv = model.get_submodule(name)

    def forward(x):
        return F.conv2d(x, conv.weight.flip(-2, -1), conv.bias, conv.stride,
                        conv.padding, conv.dilation, conv.groups)

    conv.forward = forward


# Faults planted in the reference put in the program's place.
FAULTS = ("half", "conv2")


def reference_steps(record: Dict, config: Dict, batches: List[Dict],
                    device: torch.device, precision: str = "float32") -> Dict:
    """Three reference steps from the seeded weights: the losses, the
    first clipped gradient and the parameters after the third step (host
    tensors by parameter name). ``precision`` may instead name one of
    ``FAULTS``, planted in a float32 reference: ``half`` (half of each
    batch left out, the mean over the rest), ``conv2``
    (:func:`flipped_conv2` of the reference's ``FAULT_CONV``)."""
    fault = precision if precision in FAULTS else None
    if fault is not None:
        precision = "float32"
    if fault == "half":
        batches = half_batches(batches)
    ref = reference_module(config)
    model = ref.build(config["model"], precision).to(device)
    model.load_state_dict({k: v.to(device) for k, v in
                           record["weights"].items()})
    if fault == "conv2":
        flipped_conv2(model, getattr(ref, "FAULT_CONV", DEFAULT_FAULT_CONV))
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = AdamW(params, float(config["cfg"]["SOLVER.OPTIM.LR"]),
                int(record["total_steps"]))
    losses, grad1, terms1 = [], None, None
    with ref.backends(precision):
        for i, batch in enumerate(batches):
            out, grads = train_step(model, opt, _to(batch, device))
            losses.append(float(out["total_loss"]))
            if i == 0:
                grad1 = {n: g.cpu() for n, g in zip(names, grads)}
                terms1 = {k: float(v) for k, v in out.items()
                          if k != "total_loss"}
    result = {"losses": losses, "grad1": grad1, "terms1": terms1,
              "params3": {n: p.detach().cpu() for n, p in zip(names, params)}}
    del model, opt
    return result


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               keep: List[str]) -> Tuple[float, str]:
    """(the largest |p - r| / max(r, median r) over ``keep``, its leaf)."""
    median = float(np.median([reference[k] for k in keep]))
    worst = max(keep, key=lambda k: abs(program[k] - reference[k])
                / max(reference[k], median))
    return (abs(program[worst] - reference[worst])
            / max(reference[worst], median), worst)


def compare(program: Dict, reference: Dict, p0: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """The numbers of one run against the reference, and readings beside
    them (the worst leaves' names, every step's and term's gap, the
    median leaf's gaps)."""
    ref_grad = _norms(reference["grad1"])
    median = float(np.median(list(ref_grad.values())))
    keep = [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * median]
    gaps = [abs(p - r) / abs(r) for p, r in
            zip(program["losses"], reference["losses"])]
    grad_gap, grad_leaf = worst_leaf(_norms(program["grad1"]), ref_grad, keep)
    change = {k: _norms({k: program["params3"][k] - p0[k]})[k] for k in keep}
    ref_change = {k: _norms({k: reference["params3"][k] - p0[k]})[k]
                  for k in keep}
    update_gap, update_leaf = worst_leaf(change, ref_change, keep)
    ref_median = float(np.median(list(ref_change.values())))
    update_median_gap = float(np.median([abs(change[k] - ref_change[k])
                                         / max(ref_change[k], ref_median)
                                         for k in keep]))
    term_gaps = {k: abs(v - reference["terms1"][k])
                 / max(abs(reference["terms1"][k]), 1e-12)
                 for k, v in program["terms1"].items()}
    prog_grad = _norms(program["grad1"])
    median_gap = float(np.median([abs(prog_grad[k] - ref_grad[k])
                                  / max(ref_grad[k], median) for k in keep]))
    return {"loss_gap": max(gaps), "loss_gap1": gaps[0], "grad_gap": grad_gap,
            "update_median_gap": update_median_gap,
            "update_gap": update_gap, "grad_leaf": grad_leaf,
            "update_leaf": update_leaf, "loss_gaps": gaps,
            "grad_gap_median_leaf": median_gap, "term_gaps": term_gaps,
            "term_gap": max(term_gaps.values())}


def train_check(record: Dict, config: Dict, augment: bool,
                device: torch.device, control: Optional[str] = None
                ) -> Dict[str, float]:
    """The numbers of a training cell's run; with ``control`` (names of
    precisions or of ``FAULTS``, by commas), also those of the reference
    computed so, each prefixed with its name."""
    batches = reference_batches(record, config, augment)
    numbers = {"batch_diff": float(sum(
        batch_diff(b["program"], r) for b, r in zip(record["batches"],
                                                    batches)))}
    ref = reference_steps(record, config, batches, device)
    p0 = {k: v for k, v in record["weights"].items() if k in ref["params3"]}
    numbers.update(compare(record, ref, p0))
    for name in ([] if control is None else control.split(",")):
        low = reference_steps(record, config, batches, device, name)
        numbers.update({f"{name}_{k}": v for k, v in
                        compare(low, ref, p0).items()})
    return numbers


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {name: {"value": float(numbers[name]), "limit": float(limit)}
              for name, limit in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
