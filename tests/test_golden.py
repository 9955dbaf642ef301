"""Frozen golden-corpus regression: outputs pinned from the REFERENCE
implementation (generated once by tools/make_golden.py) vs our float64
oracle and the device engine.

Unlike test_oracle_parity.py (which drives the reference code live), this
detects drift without the reference checkout present, and anchors exact
numbers across refactors.
"""
import os
from collections import OrderedDict

import numpy as np
import pytest

from degnorm_jax.config import EngineConfig, NMFConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "golden_nmfoa.npz")


@pytest.fixture(scope="module")
def golden():
    assert os.path.isfile(FIXTURE), \
        "golden fixture missing — run tools/make_golden.py"
    return np.load(FIXTURE)


def _dataset(golden):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from make_golden import golden_dataset
    cov, X = golden_dataset()
    np.testing.assert_array_equal(X, golden["x"])
    return cov, X


def _cfg(golden):
    return NMFConfig(nmf_iter=int(golden["nmf_iter"]),
                     degnorm_iter=int(golden["degnorm_iter"]))


def test_oracle_matches_golden(golden):
    from degnorm_jax.oracle.nmfoa import degnorm_fit
    cov, X = _dataset(golden)
    res = degnorm_fit(list(cov.values()), X, _cfg(golden))
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  golden["ran_baseline_selection"])
    np.testing.assert_allclose(res.rho, golden["rho"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.x_adj, golden["x_adj"], rtol=1e-8)
    np.testing.assert_allclose(res.scale_factors, golden["scale_factors"],
                               rtol=1e-8)


def test_engine_matches_golden(golden):
    """Device engine (f64 CPU path) within SVD-iteration tolerance of the
    frozen reference outputs."""
    from degnorm_jax.engine import DegNormEngine
    cov, X = _dataset(golden)
    eng = DegNormEngine(_cfg(golden),
                        EngineConfig(dtype="float64", use_pallas=False))
    res = eng.run(cov, X)
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  golden["ran_baseline_selection"])
    np.testing.assert_allclose(res.rho, golden["rho"], rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(res.x_adj, golden["x_adj"], rtol=3e-4)
