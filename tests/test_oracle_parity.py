"""Golden-oracle parity: our float64 numpy oracle must reproduce the
reference implementation (imported read-only) to numerical tolerance.

This is the anchor of the whole parity chain:
    reference (scipy/ARPACK)  ==  oracle (scipy/ARPACK)  ~=  device engine.
"""
import numpy as np
import pytest
from collections import OrderedDict

from degnorm_jax.config import NMFConfig
from degnorm_jax.oracle import nmfoa as oracle
from tests.conftest import random_coverage


def make_ref(reference_nmfoa, cfg: NMFConfig, p):
    o = reference_nmfoa(
        degnorm_iter=cfg.degnorm_iter,
        nmf_iter=cfg.nmf_iter,
        downsample_rate=cfg.downsample_rate,
        min_high_coverage=cfg.min_high_coverage,
        bins=cfg.bins,
        n_jobs=1,
        skip_baseline_selection=cfg.skip_baseline_selection,
        random_state=cfg.random_state,
    )
    o.p = p
    return o


def test_nmf_inner_loop_matches(reference_nmfoa):
    rng = np.random.default_rng(0)
    x = random_coverage(rng, 4, 240, degraded=True)
    ref = make_ref(reference_nmfoa, NMFConfig(nmf_iter=20), 4)
    K_r, E_r = ref.nmf(x, factors=True)
    K_o, E_o = oracle.nmf_oa(x, 20)
    # K.E product is sign-invariant; compare products.
    np.testing.assert_allclose(K_o @ E_o, K_r @ E_r, rtol=1e-8, atol=1e-10)


def test_ratio_svd_matches(reference_nmfoa):
    rng = np.random.default_rng(1)
    x = random_coverage(rng, 3, 180)
    ref = make_ref(reference_nmfoa, NMFConfig(), 3)
    np.testing.assert_allclose(oracle.ratio_svd(x), ref.ratio_svd(x),
                               rtol=1e-8, atol=1e-10)


def test_high_coverage_idx_matches(reference_nmfoa):
    rng = np.random.default_rng(2)
    x = random_coverage(rng, 3, 500)
    x[:, 100:200] *= 0.01
    np.testing.assert_array_equal(
        oracle.high_coverage_idx(x),
        reference_nmfoa.get_high_coverage_idx(x))


@pytest.mark.parametrize("case", range(6))
def test_baseline_selection_matches(reference_nmfoa, case):
    rng = np.random.default_rng(100 + case)
    p = [2, 3, 4, 4, 6, 3][case]
    L = [220, 450, 900, 180, 1300, 40][case]
    scale = [5, 20, 3, 50, 8, 2][case]
    F = random_coverage(rng, p, L, scale=scale, degraded=(case % 2 == 0))
    if case == 3:
        # heavy low-coverage stretch to trigger the hi-cov filter
        F[:, : L // 2] *= 0.005
    cfg = NMFConfig(nmf_iter=10)
    ref = make_ref(reference_nmfoa, cfg, p)

    rho_r, est_r, flag_r = ref.baseline_selection(F.copy())
    rho_o, est_o, flag_o = oracle.baseline_selection(F.copy(), cfg)

    assert flag_o == flag_r
    np.testing.assert_allclose(rho_o, rho_r, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(est_o, est_r, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("skip_bs", [False, True])
def test_degnorm_fit_matches(reference_nmfoa, skip_bs):
    rng = np.random.default_rng(7)
    p, n = 3, 10
    cov = [random_coverage(rng, p, int(150 + 120 * rng.random() * i),
                           scale=3 + 5 * rng.random(), degraded=(i % 2 == 0))
           for i in range(n)]
    X = np.round(np.abs(rng.standard_normal((n, p))) * 200 + 20)

    cfg = NMFConfig(nmf_iter=8, degnorm_iter=3, skip_baseline_selection=skip_bs)
    ref = make_ref(reference_nmfoa, cfg, p)
    cov_dict = OrderedDict((f"gene{i}", cov[i].copy()) for i in range(n))
    est_r = ref.run(cov_dict, X.copy())

    res = oracle.degnorm_fit([c.copy() for c in cov], X.copy(), cfg)

    np.testing.assert_allclose(res.rho, ref.rho, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.x_adj, ref.x_adj, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.scale_factors, ref.scale_factors,
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  ref.ran_baseline_selection)
    for e_o, e_r in zip(res.estimates, est_r):
        np.testing.assert_allclose(e_o, e_r, rtol=1e-5, atol=1e-7)
