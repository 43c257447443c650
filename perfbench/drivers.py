"""How a cell drives the program, chosen by its traffic file's ``kind``
(``KINDS``):

``train_step``
    ``engine.train_step.train_step`` on a ring of batches made once by
    the engine's loader at set-up and held on the card.

Set-up builds the engine, loads the seeded weights and drives the
program through its first steps by the window's own call and feed: the
first three training steps are recorded for the check (each step's loss,
the first gradient from AdamW's first moment, the parameters after the
third). The window then measures for ``seconds``; with ``trace`` a
profiler covers ``trace_steps`` steps from
``trace_start`` of the window on, between two synchronisations.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from . import trace as tr
from .counts.flops import train_flops
from .tree import ensure_tree
from .weights import seeded_state_dict

HERE = Path(__file__).resolve().parent
CHECKED_STEPS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(tree):
    """A copy on the host of a nest of dicts and tensors."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def port_cfg(config: Dict, root: str, out_dir: str, seed: int):
    """The port's config tree: defaults, the configuration file's keys,
    the run's seed and directories."""
    from monocon_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    for key, value in config["cfg"].items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        if leaf not in node:
            raise KeyError(f"{config['name']}: no config key {key}")
        node[leaf] = value
    cfg.SEED, cfg.DATA.ROOT, cfg.OUTPUT_DIR = seed, root, out_dir
    return cfg


class Profiled:
    """A profiler over a stretch of ``steps`` steps from host time ``at``
    on, between two synchronisations: :meth:`turn` before each step."""

    def __init__(self, device: torch.device, at: float, steps: int):
        self.device, self.at, self.wanted = device, at, steps
        self.prof = None
        self.t0 = 0.0
        self.steps = 0
        self.trace: Optional[tr.Trace] = None

    def turn(self) -> None:
        if self.trace is not None:
            return
        if not self.active and time.perf_counter() >= self.at:
            self.start()
        elif self.active and self.steps >= self.wanted:
            self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync(self.device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        self.trace = tr.from_profiler(self.prof, wall, self.steps)
        self.prof = None

    @property
    def active(self) -> bool:
        return self.prof is not None


class Cell:
    """One run of a cell: ``setup()``, ``window()``, then ``record`` for
    the check and ``free()``."""

    def __init__(self, name: str, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, cache: Path = HERE / "cache"):
        self.name, self.config, self.traffic = name, config, traffic
        self.cache = cache
        self.seed, self.device = seed, device
        self.batch = int(config["cfg"]["DATA.BATCH_SIZE"])
        self.pad_hw = tuple(config["cfg"]["TPU.PAD_HW"])
        self.dtype = config["dtype"]
        self.record: Dict[str, Any] = {"seed": seed}
        self.counters: Dict[str, Any] = {}
        self.profiled: Optional[Profiled] = None
        self.engine = None

    # -- shared set-up ----------------------------------------------------
    def _engine(self, split: str, count: int, is_test: bool):
        from monocon_tpu_torch.engine.engine import MonoConEngine

        root = ensure_tree(self.config["data"], split, count,
                           self.cache / "kitti")
        out = self.cache / "out" / self.name
        cfg = port_cfg(self.config, root, str(out), self.seed)
        epochs = int(self.config["cfg"]["SOLVER.OPTIM.NUM_EPOCHS"])
        self.record.update(root=root, split=split,
                           total_steps=-(-count // self.batch) * epochs)
        self.engine = MonoConEngine(cfg, auto_resume=False, is_test=is_test,
                                    device=self.device)
        self.weights = seeded_state_dict(self.engine.model.state_dict(),
                                         self.seed, self.device)
        self.record["weights"] = _host(self.weights)
        return self.engine

    def _load_weights(self) -> None:
        self.engine.model.load_state_dict(self.weights)
        del self.weights

    def _count_train_flops(self) -> None:
        """FLOPs of one forward + backward of the configuration's plain
        reference at the cell's batch and canvas, on the meta device: a
        hand-written kernel counts as the plain operations it replaces."""
        self.counters["flops_per_step"] = train_flops(
            self.config, self.batch, self.pad_hw)

    def _snapshot_grad(self) -> None:
        """The first step's gradient as AdamW got it: its first moment
        over (1 - beta1) of that step."""
        _sync(self.device)
        opt, solver = self.engine.optimizer, self.engine.solver
        beta1 = solver.hyperparams(0)[1]
        self.record["grad1"] = {
            n: (opt.state[p]["exp_avg"] / (1.0 - beta1)).cpu()
            if "exp_avg" in opt.state[p] else torch.zeros(p.shape)
            for n, p in self.engine.model.named_parameters()}

    def _snapshot_params(self) -> None:
        _sync(self.device)
        self.record["params3"] = {n: p.detach().to("cpu", copy=True)
                                  for n, p in
                                  self.engine.model.named_parameters()}

    def start_window(self, seconds: float, trace: bool) -> None:
        _sync(self.device)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds
        if trace:
            self.profiled = Profiled(
                self.device,
                self.t0 + seconds * float(self.traffic["trace_start"]),
                int(self.traffic["trace_steps"]))

    def end_window(self, steps: int, images: int) -> Dict[str, float]:
        """The window's wall, steps, images and memory peak, and the steps
        and wall outside the profiled stretch."""
        _sync(self.device)
        wall = time.perf_counter() - self.t0
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        p = self.profiled
        traced = p.trace if p is not None and p.trace is not None else None
        return {"wall": wall, "steps": steps, "images": images,
                "memory_peak_bytes": int(peak),
                "untraced_steps": steps - (traced.steps if traced else 0),
                "untraced_images": images - (traced.steps * self.batch
                                             if traced else 0),
                "untraced_wall": wall - (traced.wall if traced else 0.0)}

    def free(self) -> None:
        """Drop the program's state before the check runs."""
        self.engine = self.ring = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class TrainStep(Cell):
    def setup(self) -> None:
        from monocon_tpu_torch.data.loader import use_on_current_stream

        ring = int(self.traffic["ring_batches"])
        engine = self._engine("train", ring * self.batch, is_test=False)
        engine.train_loader.set_epoch(1)
        self.ring = [use_on_current_stream(b) for b in engine.train_loader]
        self.record["batches"] = [
            {"epoch": 1, "positions": list(range(i * self.batch,
                                                 (i + 1) * self.batch)),
             "program": _host(b)} for i, b in
            enumerate(self.ring[:CHECKED_STEPS])]
        self._count_train_flops()
        self._load_weights()
        losses = []
        for i in range(CHECKED_STEPS):
            losses.append(self._step(i))
            if i == 0:
                self._snapshot_grad()
        self._snapshot_params()
        self.record["losses"] = [float(v["total_loss"]) for v in losses]
        self.record["terms1"] = {k: float(v) for k, v in losses[0].items()
                                 if k != "total_loss"}
        for i in range(int(self.traffic["warmup_steps"])):
            self._step(CHECKED_STEPS + i)
        self.next = CHECKED_STEPS + int(self.traffic["warmup_steps"])
        _sync(self.device)

    def _step(self, i: int):
        from monocon_tpu_torch.engine.train_step import train_step

        e = self.engine
        with torch.profiler.record_function("perfbench.train_step"):
            return train_step(e.train_model, e.optimizer, e.solver,
                              self.ring[i % len(self.ring)], e.layout)

    def window(self, seconds: float, trace: bool) -> Dict[str, float]:
        self.start_window(seconds, trace)
        steps, traced = 0, []
        p = self.profiled
        while time.perf_counter() < self.deadline:
            if p is not None:
                p.turn()
            self._step(self.next + steps)
            if p is not None and p.active:
                p.steps += 1
                traced.append(self.ring[(self.next + steps) % len(self.ring)]
                              ["label"])
            steps += 1
        if p is not None and p.active:
            p.stop()
        out = self.end_window(steps, steps * self.batch)
        self.counters["traced_labels"] = [_host(l) for l in traced]
        return out


KINDS = {"train_step": TrainStep}
