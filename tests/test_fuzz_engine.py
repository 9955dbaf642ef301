"""Property-based fuzz of the full engine vs the float64 oracle.

Random gene counts, sample counts, length mixes, degradation patterns and
count magnitudes must track oracle.degnorm_fit (ARPACK float64, the proven
reference twin) through the whole fit — DI scores, adjusted counts, scale
factors and baseline-selection decisions.  rank1_method="eigh" keeps the
device rank-1 at machine precision so trim-bin argmax decisions are
deterministic (the same reason the oracle's ARPACK is).  Complements the
fixed-seed cases in tests/test_engine.py.
"""
from collections import OrderedDict

import numpy as np
import pytest

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.engine import DegNormEngine
from degnorm_jax.oracle import nmfoa as oracle
from tests.conftest import random_coverage


@pytest.fixture(scope="module", autouse=True)
def _clear_jit_caches_after():
    """The random shapes here compile ~100 distinct XLA programs; release
    them afterwards — accumulated executables have segfaulted later
    large compiles (test_stream) in full-suite runs."""
    yield
    import jax
    jax.clear_caches()


def random_dataset(rng):
    n = int(rng.integers(4, 16))
    p = int(rng.integers(2, 5))
    cov = OrderedDict()
    for i in range(n):
        kind = rng.integers(0, 4)
        L = int(rng.integers(40, 480))
        if kind == 0:      # standard degraded/undegraded mix
            m = random_coverage(rng, p, L, scale=1 + 8 * rng.random(),
                                degraded=bool(rng.integers(0, 2)))
        elif kind == 1:    # flat low coverage (bails out of selection)
            m = np.full((p, L), float(rng.integers(1, 4)))
        elif kind == 2:    # spiky
            m = np.zeros((p, L))
            spikes = rng.random((p, L)) < 0.1
            m[spikes] = rng.integers(1, 200, int(spikes.sum()))
        else:              # one near-zero sample row
            m = random_coverage(rng, p, L, scale=5)
            m[int(rng.integers(0, p))] *= 1e-3
        cov[f"g{i}"] = np.round(np.abs(m))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 200 + 20)
    return cov, X


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_engine_matches_oracle(seed):
    rng = np.random.default_rng(7000 + seed)
    cov, X = random_dataset(rng)
    cfg = NMFConfig(nmf_iter=int(rng.integers(3, 9)),
                    degnorm_iter=int(rng.integers(1, 4)))
    eng = EngineConfig(rank1_method="eigh", dtype="float64",
                       bucket_widths=(128, 256, 512))
    res = DegNormEngine(cfg, eng).run(cov, X.copy())
    gold = oracle.degnorm_fit(list(cov.values()), X.copy(), cfg)
    np.testing.assert_allclose(res.rho, gold.rho, rtol=5e-4, atol=5e-6)
    np.testing.assert_allclose(res.x_adj, gold.x_adj, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(res.scale_factors, gold.scale_factors,
                               rtol=5e-4)
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  gold.ran_baseline_selection)
    for e_j, e_o in zip(res.estimates(), gold.estimates):
        np.testing.assert_allclose(e_j, e_o, rtol=2e-3, atol=1e-3)
