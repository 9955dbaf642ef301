"""Double-float (two-f32) arithmetic accuracy (core/dfloat.py) and the
df outer-update twins vs the float64 host implementations.

The df32 representation carries ~49 significand bits; every op here must
land within ~1e-12 relative of the float64 result — orders of magnitude
below the 1e-6 plain-f32 class that round 3 measured amplifying to 4e-2
through the outer-loop feedback (BENCHMARKS.md device-loop row)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from degnorm_jax.core import dfloat as dfm
from degnorm_jax.core import degnorm as outer


def _mk(rng, shape, scale=1.0):
    x64 = (rng.random(shape) * 2 - 1) * scale + 2.0 * scale
    hi, lo = dfm.from_f64_np(x64)
    return x64, dfm.DF(jnp.asarray(hi), jnp.asarray(lo))


def _val(d: dfm.DF) -> np.ndarray:
    return dfm.to_f64_np(np.asarray(d.hi), np.asarray(d.lo))


def test_split_roundtrip():
    rng = np.random.default_rng(0)
    x64 = rng.random(1000) * 1e6
    hi, lo = dfm.from_f64_np(x64)
    # hi + lo recovers x64 to f64-double-rounding accuracy
    np.testing.assert_allclose(dfm.to_f64_np(hi, lo), x64, rtol=3e-14)
    assert np.all(np.abs(lo) <= np.abs(np.spacing(hi.astype(np.float32))))


@pytest.mark.parametrize("op,ref", [
    (dfm.add, np.add), (dfm.sub, np.subtract),
    (dfm.mul, np.multiply), (dfm.div, np.divide)])
def test_binary_ops_f64_accuracy(op, ref):
    rng = np.random.default_rng(1)
    a64, a = _mk(rng, (257, 8), 3.0)
    b64, b = _mk(rng, (257, 8), 0.7)
    got = _val(jax.jit(op)(a, b))
    np.testing.assert_allclose(got, ref(a64, b64), rtol=2e-12)


def test_dsum_compensated():
    rng = np.random.default_rng(2)
    # adversarial magnitudes: plain f32 summation loses ~1e-4 here
    x64 = np.concatenate([rng.random((20000, 4)) * 1e6,
                          rng.random((480, 4)) * 1e-3])
    hi, lo = dfm.from_f64_np(x64)
    got = _val(jax.jit(lambda d: dfm.dsum(d, axis=0))(
        dfm.DF(jnp.asarray(hi), jnp.asarray(lo))))
    want = x64.sum(axis=0)                      # f64 pairwise
    np.testing.assert_allclose(got, want, rtol=1e-11)
    # and the f32 failure mode is real (sanity that the test has teeth)
    f32_err = abs(float(x64[:, 0].astype(np.float32).sum()) - want[0])
    assert f32_err / want[0] > 1e-9


@pytest.mark.parametrize("p", [7, 8])
def test_median_matches_numpy(p):
    rng = np.random.default_rng(3)
    x64 = rng.random(p) * 100
    hi, lo = dfm.from_f64_np(x64)
    got = _val(jax.jit(dfm.median_1d)(
        dfm.DF(jnp.asarray(hi), jnp.asarray(lo))))
    np.testing.assert_allclose(got, np.median(x64), rtol=1e-13)


def test_dmax_true_df_order():
    # two values equal in f32 hi but differing in lo must order by lo
    hi = jnp.asarray(np.float32([1.0, 1.0, 0.5]))
    lo = jnp.asarray(np.float32([1e-9, 2e-9, 0.0]))
    got = dfm.dmax(dfm.DF(hi, lo), axis=0)
    assert float(got.lo) == pytest.approx(2e-9)


def test_df_iteration_math_matches_f64_host():
    """The df device twin must reproduce iteration_update (float64 numpy)
    to df64 accuracy on every output, including the correct_di_scores
    branch (some rows with rho == 0)."""
    rng = np.random.default_rng(4)
    n, p = 4097, 8
    rho_raw = rng.random((n, p)).astype(np.float32) * 1.2 - 0.1
    rho_raw[: n // 5] = 0.0                     # non-baseline-selected rows
    x = np.round(rng.random((n, p)) * 1e4 + 1)
    state = outer.init_state(np.zeros((n, p)), x)
    want = outer.iteration_update(state, rho_raw.astype(np.float64))

    xw = dfm.DF(*map(jnp.asarray, dfm.from_f64_np(state.x_weighted)))
    sc = dfm.DF(*map(jnp.asarray, dfm.from_f64_np(state.scale_factors)))
    rho, x_adj, xw_new, norm, scale = jax.jit(outer.df_iteration_math)(
        jnp.asarray(rho_raw), xw, sc)

    np.testing.assert_allclose(_val(rho), want.rho, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_val(x_adj), want.x_adj, rtol=1e-10)
    np.testing.assert_allclose(_val(xw_new), want.x_weighted, rtol=1e-10)
    np.testing.assert_allclose(_val(norm), want.norm_factors, rtol=1e-10)
    np.testing.assert_allclose(_val(scale), want.scale_factors, rtol=1e-10)


def test_df_init_math_matches_f64_host():
    rng = np.random.default_rng(5)
    n, p = 1025, 8
    cov = (rng.random((n, p)) * 1e5).astype(np.float32)
    est = cov * (1 + rng.random((n, p)).astype(np.float32))
    x = np.round(rng.random((n, p)) * 1e4 + 1)
    rho_init = outer.rho_from_ratio_svd(cov.astype(np.float64),
                                        est.astype(np.float64))
    want = outer.init_state(rho_init, x)

    xdf = dfm.DF(*map(jnp.asarray, dfm.from_f64_np(x)))
    xw, norm, rho32 = jax.jit(outer.df_init_math)(
        jnp.asarray(cov), jnp.asarray(est), xdf)
    np.testing.assert_allclose(_val(xw), want.x_weighted, rtol=1e-10)
    np.testing.assert_allclose(_val(norm), want.norm_factors, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(rho32), rho_init, rtol=1e-5,
                               atol=1e-6)


def test_df_iteration_chain_5_iters():
    """Five chained df iterations (the real outer-loop depth) stay at df64
    accuracy vs the f64 host chain — no compounding back to f32 class."""
    rng = np.random.default_rng(6)
    n, p = 513, 8
    x = np.round(rng.random((n, p)) * 1e4 + 1)
    state = outer.init_state(np.zeros((n, p)), x)
    xw = dfm.DF(*map(jnp.asarray, dfm.from_f64_np(state.x_weighted)))
    sc = dfm.DF(*map(jnp.asarray, dfm.from_f64_np(state.scale_factors)))
    step = jax.jit(outer.df_iteration_math)
    for it in range(5):
        rho_raw = (rng.random((n, p)) * 0.9).astype(np.float32)
        rho_raw[rng.random(n) < 0.3] = 0.0
        want = outer.iteration_update(state, rho_raw.astype(np.float64))
        state = want
        _, _, xw, _, sc = step(jnp.asarray(rho_raw), xw, sc)
    np.testing.assert_allclose(_val(xw), state.x_weighted, rtol=1e-9)
    np.testing.assert_allclose(_val(sc), state.scale_factors, rtol=1e-9)
