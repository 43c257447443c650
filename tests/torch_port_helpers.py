"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: JAX
variables with non-trivial BN state, and the port's detector carrying the
same weights.

Importing it caps torch's intra-op threads under pytest-xdist at each
worker's share of the cores: left alone, every worker starts one thread
per core, and six workers on eight cores run their convolutions on 48
threads. The ``default_threads`` fixture gives a test torch's own count
back."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

# Test files import this module as ``torch_port_helpers`` and as
# ``tests.torch_port_helpers``: the second copy takes the first's default.
_TWIN = sys.modules.get("tests.torch_port_helpers" if __name__ ==
                        "torch_port_helpers" else "torch_port_helpers")
DEFAULT_THREADS = getattr(_TWIN, "DEFAULT_THREADS", torch.get_num_threads())
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


@pytest.fixture()
def default_threads():
    """Run the test with torch's default intra-op thread count (one per
    core). oneDNN's float32 and bfloat16 convolutions round differently on
    fewer threads: with 1, 2 or 4 of 8, the largest elements of three
    parity tests' maps move past the tolerances they were set at (e.g.
    3 of 13824 values of a DLA-60 head map by 1.2e-4 against atol 1e-4),
    so those tests keep the count they were written for."""
    capped = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(capped)

# Tolerances of the parity tests (tests/test_model_parity.py:55,100).
F64_TOL = dict(rtol=1e-6, atol=1e-9)
F32_TOL = dict(rtol=1e-3, atol=1e-4)
# Gaussian splats and targets (tests/test_pallas_splat.py:29-30): the JAX
# paths themselves differ at the ulp (one exp against two separable ones),
# and the atol covers values that sit on the float32-eps floor.
SPLAT_TOL = dict(rtol=1e-5, atol=1e-6)


def to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturb_variables(variables, rng):
    """A copy of a JAX variable tree (numpy leaves) with random BN affines,
    biases and running stats, so that eval-mode BN and every bias do
    real work and a swapped key cannot pass unnoticed."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.normal(0.0, 0.1, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "scale":
                v = 1.0 + rng.normal(0.0, 0.1, v.shape)
            elif k == "bias":
                v = v + rng.normal(0.0, 0.05, v.shape)
            out[k] = v.astype(np.float32)
        return out
    return walk(to_numpy_tree(variables))


def port_detector(variables, dtype=torch.float32):
    """The port's DLA-34 detector on the CPU with the JAX weights."""
    from monocon_tpu_torch.models.detector import create_detector
    from monocon_tpu_torch.utils.weights import state_dict_from_jax

    model = create_detector(device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.to(dtype)


def assert_same(a, b, path="") -> None:
    """``a`` and ``b`` are equal all the way down: dicts, sequences, numpy
    arrays (same dtype and values), tensors (as numpy), objects (by their
    attributes) and scalars."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    if isinstance(b, torch.Tensor):
        b = b.numpy()
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (
            path, getattr(b, "dtype", type(b)), a.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, (path, a, b)
        assert_same(vars(a), vars(b), path)
    else:
        assert a == b, (path, a, b)


def jax_x64_tree(tree):
    """numpy tree -> float64 jnp tree (call inside jax.enable_x64)."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(a),
        tree)
