"""Parity of the batched masked JAX core vs the float64 golden oracle.

Chain: reference (ARPACK) == oracle (ARPACK) ~= JAX core (power iteration /
eigh on the p x p Gram matrix). Tests here run the core in float64 on CPU;
float32 device tolerances are covered in test_engine.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.core.linalg import masked_rank_one, outer_product
from degnorm_jax.core.nmf import nmf_masked, ratio_svd_rowsums
from degnorm_jax.core.baseline import baseline_select_bucket, materialize_estimate
from degnorm_jax.oracle import nmfoa as oracle
from tests.conftest import random_coverage


def make_bucket(mats, W, dtype=np.float64):
    """Pad a list of (p, L_i) matrices into (G, p, W) + length mask."""
    G, p = len(mats), mats[0].shape[0]
    F = np.zeros((G, p, W), dtype=dtype)
    mask = np.zeros((G, W), dtype=bool)
    for i, m in enumerate(mats):
        F[i, :, : m.shape[1]] = m
        mask[i, : m.shape[1]] = True
    return jnp.asarray(F), jnp.asarray(mask)


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_masked_rank_one_matches_svds(method):
    rng = np.random.default_rng(3)
    mats = [random_coverage(rng, 4, L, degraded=True) for L in (100, 230, 256)]
    F, mask = make_bucket(mats, 256)
    K, E, _ = masked_rank_one(F, mask, n_iters=200, method=method)
    for i, m in enumerate(mats):
        K_o, E_o = oracle.rank_one(m)
        prod_o = K_o @ E_o
        prod_j = np.outer(np.asarray(K)[i], np.asarray(E)[i, : m.shape[1]])
        np.testing.assert_allclose(prod_j, prod_o, rtol=1e-6, atol=1e-8)
        # masked columns must carry exactly zero weight
        assert np.all(np.asarray(E)[i, m.shape[1]:] == 0)


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_nmf_masked_matches_oracle(method):
    rng = np.random.default_rng(4)
    mats = [random_coverage(rng, 3, L, degraded=True) for L in (150, 200)]
    F, mask = make_bucket(mats, 200)
    K, E, _ = nmf_masked(F, mask, nmf_iter=15, power_iters_cold=200,
                         power_iters_warm=40, method=method)
    for i, m in enumerate(mats):
        K_o, E_o = oracle.nmf_oa(m, 15)
        prod_o = K_o @ E_o
        prod_j = np.outer(np.asarray(K)[i], np.asarray(E)[i, : m.shape[1]])
        np.testing.assert_allclose(prod_j, prod_o, rtol=1e-5, atol=1e-7)


def test_ratio_svd_rowsums_matches_oracle():
    rng = np.random.default_rng(5)
    mats = [random_coverage(rng, 3, L) for L in (120, 300)]
    F, mask = make_bucket(mats, 300)
    cs, es = ratio_svd_rowsums(F, mask, power_iters=200)
    for i, m in enumerate(mats):
        est = oracle.ratio_svd(m)
        np.testing.assert_allclose(np.asarray(cs)[i], m.sum(axis=1),
                                   rtol=1e-9)
        np.testing.assert_allclose(np.asarray(es)[i], est.sum(axis=1),
                                   rtol=1e-6)


def _run_bucket_vs_oracle(mats, cfg, eng, W):
    F, mask = make_bucket(mats, W)
    res = baseline_select_bucket(F, mask, cfg, eng)
    for i, m in enumerate(mats):
        rho_o, est_o, flag_o = oracle.baseline_selection(m, cfg)
        rho_j = np.asarray(res.rho)[i]
        np.testing.assert_allclose(
            rho_j, rho_o, rtol=2e-4, atol=2e-6,
            err_msg=f"rho mismatch gene {i}")
        assert bool(np.asarray(res.ran_bs)[i]) == flag_o, f"flag gene {i}"
        est_j = materialize_estimate(
            np.asarray(F)[i], m.shape[1], np.asarray(res.est_K)[i],
            np.asarray(res.est_E)[i], int(np.asarray(res.est_kind)[i]))
        np.testing.assert_allclose(
            est_j, est_o, rtol=5e-4, atol=1e-4,
            err_msg=f"estimate mismatch gene {i}")


@pytest.mark.parametrize("method", ["eigh", "power"])
def test_baseline_bucket_matches_oracle(method):
    rng = np.random.default_rng(11)
    mats = []
    # a spread of shapes/regimes: short, long, degraded, low-coverage-heavy
    for i, L in enumerate((210, 350, 500, 120, 480)):
        m = random_coverage(rng, 3, L, scale=4 + 6 * rng.random(),
                            degraded=(i % 2 == 0))
        if i == 3:
            m[:, :60] *= 0.004   # force a narrow hi-cov window
        mats.append(m)
    cfg = NMFConfig(nmf_iter=10)
    eng = EngineConfig(rank1_method=method, power_iters_cold=200,
                       power_iters_warm=60, dtype="float64")
    _run_bucket_vs_oracle(mats, cfg, eng, 512)


def test_baseline_bucket_skip_baseline():
    rng = np.random.default_rng(12)
    mats = [random_coverage(rng, 4, L, degraded=True) for L in (260, 400)]
    cfg = NMFConfig(nmf_iter=8, skip_baseline_selection=True)
    eng = EngineConfig(rank1_method="eigh", dtype="float64")
    _run_bucket_vs_oracle(mats, cfg, eng, 512)


def test_baseline_bucket_tiny_genes_bail():
    """Genes below min_high_coverage must bail with rho=0, estimate=F."""
    rng = np.random.default_rng(13)
    mats = [random_coverage(rng, 3, 30), random_coverage(rng, 3, 40)]
    cfg = NMFConfig(nmf_iter=5)
    eng = EngineConfig(rank1_method="eigh", dtype="float64")
    F, mask = make_bucket(mats, 64)
    res = baseline_select_bucket(F, mask, cfg, eng)
    assert np.all(np.asarray(res.bailed))
    np.testing.assert_array_equal(np.asarray(res.rho), 0.0)


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_rank_one_uv_finish_matches_masked_rank_one(method):
    """The scale-free carry (masked_rank_one_uv + finish_rank_one) must
    reproduce masked_rank_one BITWISE on the same iterate: uv skips only
    the scale tail, and finish_rank_one replays that tail in the same op
    order (core/linalg.py; the Lagrangian loops rely on the est = u ⊗ v
    identity this pins down)."""
    from degnorm_jax.core.linalg import finish_rank_one, masked_rank_one_uv

    rng = np.random.default_rng(11)
    mats = [random_coverage(rng, 4, L, degraded=True) for L in (90, 200, 256)]
    F, mask = make_bucket(mats, 256)
    K1, E1, u1 = masked_rank_one(F, mask, n_iters=32, method=method)
    u2, v2 = masked_rank_one_uv(F, mask, n_iters=32, method=method)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    K2, E2 = finish_rank_one(F, mask, u2, v2)
    np.testing.assert_array_equal(np.asarray(K1), np.asarray(K2))
    np.testing.assert_array_equal(np.asarray(E1), np.asarray(E2))
    # the scale-cancellation identity itself: K·E == u ⊗ v up to the f32/
    # f64 divide-multiply round trip
    np.testing.assert_allclose(
        np.asarray(outer_product(K2, E2)),
        np.asarray(outer_product(u2, v2)), rtol=1e-12, atol=1e-12)
