"""Test harness config.

Tests run JAX on CPU with 8 virtual devices so multi-device sharding logic is
exercised without accelerator hardware. This must happen before `jax` is
imported anywhere.  Tests marked ``gpu`` need a card and skip here (see the
``gpu_device`` fixture); run them on a GPU host with
``DEGNORM_TEST_GPU=1 python -m pytest tests/test_pallas.py -m gpu``.
"""
import os
import sys
import types

if os.environ.get("DEGNORM_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Enable float64 so parity tests can run the device kernels at oracle
# precision on CPU (the production device path is float32).
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

if os.environ.get("DEGNORM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


REFERENCE_ROOT = "/root/reference"


def load_reference_nmf():
    """Import the reference implementation (read-only) for parity tests.

    The reference's utils module imports pkg_resources, which this
    environment lacks; stub it out. Returns the GeneNMFOA class or None if
    the reference tree is unavailable.
    """
    if not os.path.isdir(os.path.join(REFERENCE_ROOT, "degnorm")):
        return None
    if "pkg_resources" not in sys.modules:
        stub = types.ModuleType("pkg_resources")
        stub.resource_filename = lambda *a, **k: "/dev/null"
        sys.modules["pkg_resources"] = stub
    if REFERENCE_ROOT not in sys.path:
        sys.path.append(REFERENCE_ROOT)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from degnorm.nmf import GeneNMFOA  # noqa
    return GeneNMFOA


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` run the kernels as
    compiled for the card, which has no CPU interpreter equivalent.  Decided
    here, at run time, never at import (every xdist worker must collect
    the same tests)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (on the card: DEGNORM_TEST_GPU=1 "
                    "python -m pytest tests/test_pallas.py -m gpu)")
    return gpus[0]


@pytest.fixture(scope="session")
def reference_nmfoa():
    cls = load_reference_nmf()
    if cls is None:
        pytest.skip("reference implementation not available")
    return cls


def random_coverage(rng, p, L, scale=10.0, degraded=False):
    """Synthesize a plausible coverage matrix: smooth positive envelope with
    sample-specific degradation ramps (mimics RNA-seq 3' bias)."""
    t = np.linspace(0, 1, L)
    base = scale * (0.25 + np.abs(np.sin(np.pi * t) + 0.3 * rng.standard_normal(L) * 0.05))
    rows = []
    for j in range(p):
        amp = 0.5 + rng.random() * 1.5
        row = amp * base
        if degraded and j % 2 == 1:
            # exponential decay toward the 5' end for odd samples
            row = row * np.exp(-2.0 * (1 - t) * rng.random())
        rows.append(row)
    F = np.maximum(np.vstack(rows), 0.0)
    return np.round(F, 3)
