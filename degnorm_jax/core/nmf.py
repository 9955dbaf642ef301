"""Batched masked NMF-over-approximation inner loop.

Device equivalent of the reference's per-gene ``GeneNMFOA.nmf``
(``degnorm/nmf.py:78-107``): a clipped-Lagrangian fixed point that
repeatedly refits a rank-1 factorization to ``x + lambda``.  Runs for a whole
(G, p, W) gene bucket at once under ``lax.fori_loop``; masked columns carry
zero coverage and zero multipliers throughout, which is exact (the rank-1
factors of [A | 0] are those of A — see core/linalg.py).

The final over-approximation clip is intentionally NOT applied here: the
reference comments it out inside ``nmf`` (nmf.py:104-106) and clips
selectively at call sites (nmf.py:318,345,352,365).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from degnorm_jax.core.linalg import (finish_rank_one, masked_rank_one,
                                     masked_rank_one_uv, outer_product)
from degnorm_jax.ops import nmf_gpu

_HIGHEST = jax.lax.Precision.HIGHEST


def nmf_masked(
    F: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    method: str = "power",
    use_gpu_kernel: bool = False,
    pallas_interpret: bool = False,
    gene_active=None,
    u0: Optional[jnp.ndarray] = None,
    nmf_tol: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run the NMF-OA loop on a masked gene bucket.

    Args:
      F: (G, p, W) nonnegative coverage batch (already scale-adjusted).
      mask: (G, W) active-column mask.
      nmf_iter: number of Lagrangian iterations (reference ``nmf_iter``).
      use_gpu_kernel: route through the Pallas GPU kernel (ops/nmf_gpu.py)
        when its gate admits the bucket; otherwise the XLA loop below runs.
      pallas_interpret: run that kernel in the Pallas interpreter (CPU).
      gene_active: optional (G,) bool; the GPU kernel returns at once with
        zero outputs for inactive genes (callers gate every consumer on
        their own masks, as the trim loop does).  The XLA loop computes
        all genes regardless.
      u0: optional (G, p) warm start for the initial cold rank-1 (the trim
        loop resumes from the previous round's left vectors with a reduced
        power_iters_cold — the Perron fixed point is unchanged).
      nmf_tol: > 0 enables OPT-IN adaptive convergence (EngineConfig.
        nmf_tol): each gene freezes its (X, K, E, u) once max|ΔK| <=
        nmf_tol * max|K| in one iteration, and the loop exits early when
        all genes are frozen.  Per-gene freezing makes results invariant
        to batching.  XLA loop only.

    Returns (K, E, u): rank-1 factors (G,p), (G,W) and the final unit left
    vector for warm starts. K, E are nonnegative (Perron orientation);
    their product matches the reference's signed factors' product.
    """
    if use_gpu_kernel and nmf_gpu.kernel_supported(
            F.shape, F.dtype, method=method, nmf_tol=nmf_tol):
        return nmf_gpu.nmf_masked_gpu(
            F, mask, nmf_iter=nmf_iter,
            power_iters_cold=power_iters_cold,
            power_iters_warm=power_iters_warm,
            gene_active=gene_active, u0=u0,
            interpret=pallas_interpret)

    m = mask.astype(F.dtype)
    A0 = F * m[:, None, :]

    step = 1.0 / jnp.sqrt(jnp.asarray(nmf_iter, F.dtype))

    # X-form of the multiplier update (kept in lockstep with the GPU
    # kernel, ops/nmf_gpu.py): carrying X = A0 + lambda
    # directly, the reference's  lam <- max(lam - step*(est - A0), 0)
    # becomes  X <- max(X - step*(est - A0), A0)  — identical over the
    # reals, one fewer elementwise pass; floating-point drift is
    # reassociation-class only.  Masked columns stay exactly zero (est and
    # A0 both vanish there, so max(0 - 0, 0) = 0).
    #
    # Scale-free carry (also in lockstep with the GPU kernel): est = K·E ==
    # u ⊗ (Xᵀu) exactly — the singular value cancels — so the loop carries
    # (u, v = Xᵀu) and skips masked_rank_one's per-iteration Rayleigh/
    # sqrt/divide tail; K, E materialize once after the loop.
    def body(_, carry):
        X, K, E, u = carry
        est = outer_product(K, E)
        X = jnp.maximum(X - step * (est - A0), A0)
        K, E, u = masked_rank_one(X, mask, n_iters=power_iters_warm,
                                  u0=u, method=method)
        return X, K, E, u

    if nmf_tol > 0:
        K, E, u = masked_rank_one(F, mask, n_iters=power_iters_cold,
                                  method=method, u0=u0)
        # Adaptive convergence (EngineConfig.nmf_tol, opt-in): per-gene
        # freeze + all-frozen early exit.  A frozen gene's state stops
        # updating entirely (X included), so values depend only on each
        # gene's own history: invariant to batching.
        tol = jnp.asarray(nmf_tol, F.dtype)

        def cond_a(carry):
            i, X, K, E, u, done = carry
            return (i < nmf_iter) & ~jnp.all(done)

        def body_a(carry):
            i, X, K, E, u, done = carry
            Xn, Kn, En, un = body(i, (X, K, E, u))
            X = jnp.where(done[:, None, None], X, Xn)
            Kn = jnp.where(done[:, None], K, Kn)
            En = jnp.where(done[:, None], E, En)
            un = jnp.where(done[:, None], u, un)
            delta = jnp.max(jnp.abs(Kn - K), axis=1)
            ref = jnp.maximum(jnp.max(jnp.abs(Kn), axis=1), 1e-30)
            done = done | (delta <= tol * ref)
            return i + 1, X, Kn, En, un, done

        carry = (jnp.zeros((), jnp.int32), A0, K, E, u,
                 jnp.zeros((F.shape[0],), bool))
        _, X, K, E, u, _ = jax.lax.while_loop(cond_a, body_a, carry)
        return K, E, u

    u, v = masked_rank_one_uv(F, mask, n_iters=power_iters_cold,
                              method=method, u0=u0)

    def body_uv(_, carry):
        X, u, v = carry
        est = outer_product(u, v)
        X = jnp.maximum(X - step * (est - A0), A0)
        u, v = masked_rank_one_uv(X, mask, n_iters=power_iters_warm,
                                  u0=u, method=method)
        return X, u, v

    X, u, v = jax.lax.fori_loop(0, nmf_iter, body_uv, (A0, u, v))
    K, E = finish_rank_one(X, mask, u, v)
    return K, E, u


def ratio_svd_rowsums(
    F: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    power_iters: int = 30,
    method: str = "power",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Row sums of the one-shot clipped rank-1 over-approximation.

    Device version of reference ``ratio_svd`` (nmf.py:109-121) returning only
    what DegNorm initialization needs (nmf.py:522-526): per-sample sums of
    max(K·E, F) and of F, both over active columns.
    """
    m = mask.astype(F.dtype)
    K, E, _ = masked_rank_one(F, mask, n_iters=power_iters, method=method)
    est = jnp.maximum(outer_product(K, E), F * m[:, None, :])
    est_sums = jnp.einsum("gpw,gw->gp", est, m, precision=_HIGHEST)
    cov_sums = jnp.einsum("gpw,gw->gp", F, m, precision=_HIGHEST)
    return cov_sums, est_sums
