"""Downsampling paths: oracle-vs-reference parity (serial mode is
deterministic) and engine keyed-PRNG reproducibility."""
import numpy as np
import pytest
from collections import OrderedDict

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.engine import DegNormEngine
from degnorm_jax.oracle import nmfoa as oracle
from tests.conftest import random_coverage


def test_oracle_downsample_matches_reference(reference_nmfoa):
    """With n_jobs=1 the reference's global-RNG draws are sequential, so
    the oracle (same seed, same gene order) must match exactly."""
    rng = np.random.default_rng(70)
    p, n = 3, 6
    cov = [random_coverage(rng, p, int(300 + 100 * i), degraded=(i % 2 == 0))
           for i in range(n)]
    X = np.round(np.abs(rng.standard_normal((n, p))) * 150 + 20)
    cfg = NMFConfig(nmf_iter=6, degnorm_iter=2, downsample_rate=4)

    ref = reference_nmfoa(degnorm_iter=2, nmf_iter=6, downsample_rate=4,
                          n_jobs=1, random_state=123)
    ref.run(OrderedDict((f"g{i}", cov[i].copy()) for i in range(n)),
            X.copy())
    res = oracle.degnorm_fit([c.copy() for c in cov], X.copy(), cfg)
    np.testing.assert_allclose(res.rho, ref.rho, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.x_adj, ref.x_adj, rtol=1e-6, atol=1e-8)


def test_engine_downsample_deterministic():
    """Engine downsampling draws per-(gene, iteration) keyed offsets —
    two identical runs must agree exactly (unlike the reference's
    thread-racy global RNG, SURVEY.md §2.2)."""
    rng = np.random.default_rng(71)
    cov = OrderedDict(
        (f"g{i}", random_coverage(rng, 3, 400 + 50 * i, degraded=True))
        for i in range(5))
    X = np.round(np.abs(rng.standard_normal((5, 3))) * 150 + 20)
    cfg = NMFConfig(nmf_iter=5, degnorm_iter=2, downsample_rate=3)
    eng = EngineConfig(dtype="float64", bucket_widths=(1024,))
    r1 = DegNormEngine(cfg, eng).run(cov, X)
    r2 = DegNormEngine(cfg, eng).run(cov, X)
    np.testing.assert_array_equal(r1.rho, r2.rho)
    # rho values are sane
    assert np.isfinite(r1.rho).all()
    assert (r1.rho <= 0.9 + 1e-12).all()
