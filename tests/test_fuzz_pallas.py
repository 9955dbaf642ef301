"""Random-shape fuzz: the XLA trim loop calling the interpreted GPU
kernel vs the plain XLA path.

Complements the fixed-shape cases in tests/test_pallas.py: random
(G, p, W, nmf_iter) combinations with random nmf_tol settings must keep
the kernel route in lockstep with the XLA while_loop's decisions.  Widths
that are not powers of two, and nmf_tol > 0, fall outside the kernel's
gate and must then take the XLA loop unchanged.
"""
import numpy as np
import pytest

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.core.baseline import baseline_select_bucket
from tests.conftest import random_coverage
from tests.test_core_parity import make_bucket


@pytest.fixture(scope="module", autouse=True)
def _clear_jit_caches_after():
    # random shapes compile many distinct programs; release them (see
    # tests/test_fuzz_engine.py for the accumulated-executable hazard)
    yield
    import jax
    jax.clear_caches()


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_pallas_trim_matches_xla(trial):
    r = np.random.default_rng(424242 + trial)
    p = int(r.integers(2, 9))
    W = int(r.choice([128, 256, 384, 512]))
    G = int(r.integers(3, 12))
    nmf_iter = int(r.integers(4, 16))
    tol = float(r.choice([0.0, 0.0, 1e-4, 1e-3]))
    r.integers(0, 2)       # keeps each trial's data stream unchanged
    mats = [random_coverage(r, p, int(r.integers(max(40, W // 4), W)),
                            scale=1 + 10 * r.random(),
                            degraded=bool(r.integers(0, 2))
                            ).astype(np.float32)
            for _ in range(G)]
    F, mask = make_bucket(mats, W, dtype=np.float32)
    cfg = NMFConfig(nmf_iter=nmf_iter)
    rx = baseline_select_bucket(
        F, mask, cfg, EngineConfig(use_pallas=False, nmf_tol=tol))
    rp = baseline_select_bucket(
        F, mask, cfg, EngineConfig(use_pallas=True, pallas_interpret=True,
                                   nmf_tol=tol))
    np.testing.assert_array_equal(np.asarray(rx.bailed),
                                  np.asarray(rp.bailed))
    np.testing.assert_array_equal(np.asarray(rx.ran_bs),
                                  np.asarray(rp.ran_bs))
    np.testing.assert_allclose(np.asarray(rp.rho), np.asarray(rx.rho),
                               rtol=5e-2, atol=5e-3)
