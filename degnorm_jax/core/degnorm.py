"""DegNorm outer-loop state updates (host-side, float64).

These are the tiny O(n·p) global reductions between device bucket steps —
the exact update rules of reference ``GeneNMFOA.run`` (nmf.py:483-601).
They stay in float64 numpy: the data is kilobytes, the medians and
cumulative scale-factor products are precision-sensitive, and keeping them
on host avoids a device round-trip per quantity.  The heavy per-gene work
lives in core/baseline.py on device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class GlobalState(NamedTuple):
    """Cross-gene DegNorm state (all numpy float64)."""
    x: np.ndarray              # (n, p) raw read counts
    x_weighted: np.ndarray     # (n, p) counts / cumulative norm factors
    x_adj: np.ndarray          # (n, p) degradation-adjusted counts
    rho: np.ndarray            # (n, p) DI scores in [0, 0.9]
    norm_factors: np.ndarray   # (p,) last iteration's norm factors
    scale_factors: np.ndarray  # (p,) cumulative coverage scale factors


def init_state(rho_init: np.ndarray, counts: np.ndarray) -> GlobalState:
    """DegNorm initialization from ratio-SVD DI scores (nmf.py:512-535):
    norm factors come from column sums over low-DI genes (max rho < 0.1),
    falling back to all genes; read counts are depth-normalized by them."""
    x = np.array(counts, dtype=np.float64)
    low_di = rho_init.max(axis=1) < 0.1
    count_sums = x[low_di].sum(axis=0) if low_di.any() else x.sum(axis=0)
    norm_factors = count_sums / np.median(count_sums)
    x_weighted = x / norm_factors
    return GlobalState(
        x=x,
        x_weighted=x_weighted,
        x_adj=x_weighted.copy(),
        rho=np.array(rho_init, dtype=np.float64),
        norm_factors=norm_factors,
        scale_factors=norm_factors.copy(),
    )


def iteration_update(state: GlobalState, rho_raw: np.ndarray) -> GlobalState:
    """Post-baseline-selection global update (nmf.py:396-399,574-590):

    1. clip DI scores to [0, 0.9];
    2. genes that never ran baseline selection (row max == 0) receive the
       sample-average DI score (correct_di_scores, nmf.py:148-158);
    3. re-adjust weighted counts, refresh norm factors (column sums over
       their median), fold them into the cumulative scale factors.
    """
    rho = np.clip(np.array(rho_raw, dtype=np.float64), 0.0, 0.9)

    x_adj = state.x_weighted / (1 - rho)
    non_bs = rho.max(axis=1) == 0
    if non_bs.any():
        sample_avg = 1 - state.x_weighted.sum(axis=0) / x_adj.sum(axis=0)
        rho[non_bs, :] = sample_avg

    x_adj = state.x_weighted / (1 - rho)
    col = x_adj.sum(axis=0)
    norm_factors = col / np.median(col)
    x_weighted = state.x_weighted / norm_factors
    scale_factors = state.scale_factors * norm_factors

    return GlobalState(x=state.x, x_weighted=x_weighted, x_adj=x_adj,
                       rho=rho, norm_factors=norm_factors,
                       scale_factors=scale_factors)


def device_iteration_math(rho_raw, x_weighted, scale_factors):
    """jnp twin of ``iteration_update`` — the single device-side
    implementation of the post-baseline-selection global update, shared by
    the engine's device-resident outer loop (engine.py) and the fused
    sharded step (parallel/sharded.py; there the cross-gene column sums
    become implicit psums over the gene shards).  Keep the op order in
    lockstep with ``iteration_update`` above.

    Returns (rho, x_adj, x_weighted_new, norm_factors, scale_factors_new).
    """
    import jax.numpy as jnp
    rho = jnp.clip(rho_raw, 0.0, 0.9)
    x_adj = x_weighted / (1 - rho)
    non_bs = jnp.max(rho, axis=1) == 0
    sample_avg = 1 - jnp.sum(x_weighted, axis=0) / jnp.sum(x_adj, axis=0)
    rho = jnp.where(non_bs[:, None], sample_avg[None, :], rho)
    x_adj = x_weighted / (1 - rho)
    col = jnp.sum(x_adj, axis=0)
    norm = col / jnp.median(col)
    return rho, x_adj, x_weighted / norm, norm, scale_factors * norm


def rho_from_ratio_svd(cov_sums: np.ndarray, est_sums: np.ndarray) -> np.ndarray:
    """Initial DI scores 1 - sum(F)/(sum(est)+1) (nmf.py:524-526)."""
    return 1 - cov_sums / (est_sums + 1)


# ---- double-float device twins (f64-grade outer updates in f32) ---------
#
# The device loop runs in f32; the plain-f32 ``device_iteration_math`` perturbs
# the cumulative scale factors by ~1e-6 relative per iteration, which
# chaotically amplifies through borderline trim decisions (measured
# adjusted-count maxrel 4e-2 vs the f64 host loop, BENCHMARKS.md round 3).
# These twins run the SAME op order in two-float32 compensated arithmetic
# (core/dfloat.py, ~49-bit significand), shrinking the per-op perturbation
# to ~1e-14 — below the threshold where borderline decisions flip — so the
# device-resident outer loop matches the host loop's float64 updates to
# f64-rounding-class accuracy and can be the single-chip default.

def df_iteration_math(rho_raw, xw, scale):
    """Double-float twin of ``iteration_update`` / ``device_iteration_math``
    (reference nmf.py:396-399,574-590).  ``xw``/``scale`` are dfloat.DF
    pairs; ``rho_raw`` is the kernels' (n, p) f32 output (exactly what the
    f64 host loop receives).  Returns (rho, x_adj, xw', norm, scale') as
    DF pairs — callers recombine to float64 on host via dfloat.to_f64_np.
    """
    import jax.numpy as jnp

    from degnorm_jax.core import dfloat as dfm

    # clip to [0, 0.9] in df: the upper bound 0.9 is NOT f32-representable
    # (f32(0.9) is 2.4e-8 low), and the host loop clips in float64 — so
    # clipped entries must take the df representation of the f64 0.9 or
    # every deep-degradation row's 1/(1-rho) shifts by f32-class error.
    lo_clip = jnp.maximum(rho_raw, 0.0)         # exact in f32
    hi09, lo09 = dfm.from_f64_np(np.float64(0.9))
    up = dfm.DF(jnp.full_like(lo_clip, hi09), jnp.full_like(lo_clip, lo09))
    # lo09 > 0, so raw f32 values exceed f64 0.9 iff raw > hi09
    clip_up = lo_clip > jnp.asarray(hi09, lo_clip.dtype)
    rho = dfm.where(clip_up, up, dfm.lift(lo_clip))
    rho32 = dfm.to_f32(rho)
    one = dfm.const(1.0, rho32)
    x_adj = dfm.div(xw, dfm.sub(one, rho))
    non_bs = jnp.max(rho32, axis=1) == 0
    sum_xw = dfm.dsum(xw, axis=0)               # (p,)
    sum_adj = dfm.dsum(x_adj, axis=0)
    sample_avg = dfm.sub(dfm.const(1.0, sum_xw.hi),
                         dfm.div(sum_xw, sum_adj))
    rho = dfm.where(non_bs[:, None],
                    dfm.DF(sample_avg.hi[None, :], sample_avg.lo[None, :]),
                    rho)
    x_adj = dfm.div(xw, dfm.sub(one, rho))
    col = dfm.dsum(x_adj, axis=0)
    med = dfm.median_1d(col)
    norm = dfm.div(col, dfm.DF(jnp.broadcast_to(med.hi, col.hi.shape),
                               jnp.broadcast_to(med.lo, col.hi.shape)))
    xw_new = dfm.div(xw, dfm.DF(norm.hi[None, :], norm.lo[None, :]))
    scale_new = dfm.mul(scale, norm)
    return rho, x_adj, xw_new, norm, scale_new


def df_init_math(cov_sums, est_sums, x):
    """Double-float twin of ``init_state`` + ``rho_from_ratio_svd``
    (nmf.py:512-535).  ``cov_sums``/``est_sums`` are the kernels' (n, p)
    f32 ratio-SVD row sums; ``x`` is the raw count matrix as a DF pair.
    Returns (xw, norm, rho) — xw/norm as DF, rho as the (n, p) f32 initial
    DI (for the engine's presort; threshold decisions use the df value).
    """
    import jax.numpy as jnp

    from degnorm_jax.core import dfloat as dfm

    cov = dfm.lift(cov_sums)
    est = dfm.lift(est_sums)
    rho = dfm.sub(dfm.const(1.0, cov_sums),
                  dfm.div(cov, dfm.add(est, dfm.const(1.0, est_sums))))
    # low-DI gene set: max_p rho < 0.1 in true df order (nmf.py:529-531).
    # 0.1 is not f32-representable (f32(0.1) is 1.5e-9 HIGH), so the
    # threshold is its df split, like the 0.9 clip in df_iteration_math.
    hi01, lo01 = dfm.from_f64_np(np.float64(0.1))
    rmax = dfm.dmax(rho, axis=1)                # (n,)
    low_di = (rmax.hi < hi01) | ((rmax.hi == hi01) & (rmax.lo < lo01))
    any_low = jnp.any(low_di)
    zeros = dfm.DF(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))
    masked = dfm.where(low_di[:, None], x, zeros)
    sums_low = dfm.dsum(masked, axis=0)
    sums_all = dfm.dsum(x, axis=0)
    count_sums = dfm.where(any_low, sums_low, sums_all)
    med = dfm.median_1d(count_sums)
    norm = dfm.div(count_sums,
                   dfm.DF(jnp.broadcast_to(med.hi, count_sums.hi.shape),
                          jnp.broadcast_to(med.lo, count_sums.hi.shape)))
    xw = dfm.div(x, dfm.DF(norm.hi[None, :], norm.lo[None, :]))
    return xw, norm, dfm.to_f32(rho)
