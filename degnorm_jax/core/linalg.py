"""Batched, masked rank-1 factorization — the hot kernel of DegNorm.

The reference computes a rank-1 truncated SVD per gene with ARPACK
(``scipy.sparse.linalg.svds``, reference ``degnorm/nmf.py:55-64``), one gene
at a time on the host.  On the device we batch G genes into a padded (G, p, W)
array and exploit the structure of the problem:

* ``p`` (samples) is tiny (2-32) while ``W`` (positions) is large, so the
  dominant left singular vector ``u`` of A is the dominant eigenvector of
  the small Gram matrix  B = A Aᵀ  (p x p).  Computing B is one batched
  contraction over W — the only O(p²·W) op — and the eigenvector extraction
  is O(p²) per step.
* A = F ⊙ mask is elementwise nonnegative, so B is nonnegative and the
  dominant eigenvector is the Perron vector: power iteration from a strictly
  positive start converges and never needs deflation, and the returned
  (u, v) pair can be canonicalized nonnegative — ARPACK's arbitrary sign
  (nmf.py:58-64) only ever feeds sign-invariant K·E products or ``abs(K)``.
* Zeroing masked columns is *exact* for the rank-1 factors: the singular
  triplet of [A | 0] is (u, s, [v; 0]) (SURVEY.md §7.2), so high-coverage
  filtering, downsampling and bin-dropping all become column masks on a
  fixed-width buffer — no ragged shapes, no recompilation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-30
# Every contraction here is f32 at full precision: on a GPU an f32 einsum
# may otherwise run in TF32 (about three decimal digits).
_HIGHEST = jax.lax.Precision.HIGHEST


def _gram(A: jnp.ndarray) -> jnp.ndarray:
    """Batched B = A Aᵀ over the wide axis: (G,p,W) -> (G,p,p)."""
    return jnp.einsum("gpw,gqw->gpq", A, A,
                      preferred_element_type=A.dtype, precision=_HIGHEST)


def _power_iterate(B: jnp.ndarray, u0: jnp.ndarray, n_iters: int) -> jnp.ndarray:
    """Dominant-eigenvector iteration on batched PSD matrices.

    Same squared-operator pair-stepping scheme as the GPU kernel
    (ops/nmf_gpu.py::_power): normalize the Gram (PSD ⇒ normalized
    spectral radius in [1, p]), square it once, and apply B² twice per loop
    body without intermediate normalization — four plain power steps per
    body with a ~2x shorter sequential chain.  ``n_iters`` is therefore
    EFFECTIVELY rounded to 4 * max(1, n_iters // 4) plain steps (e.g. 6 ->
    4, 30 -> 28, 2 -> 4); callers tune counts in multiples of 4.  Keeps the
    previous iterate when the update collapses (all-zero B), so a zero gene
    degrades to s=0 instead of NaN.
    """
    bmax = jnp.max(jnp.abs(B), axis=(1, 2), keepdims=True)
    Bn = B / (bmax + _EPS)
    B2 = jnp.einsum("gik,gkj->gij", Bn, Bn, preferred_element_type=B.dtype,
                    precision=_HIGHEST)

    def body(_, u):
        v = _matvec(B2, u)
        w = _matvec(B2, v)
        nrm = jnp.linalg.norm(w, axis=-1, keepdims=True)
        return jnp.where(nrm > _EPS, w / (nrm + _EPS), u)

    return jax.lax.fori_loop(0, max(1, n_iters // 4), body, u0)


def _matvec(B: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("gpq,gq->gp", B, u, preferred_element_type=B.dtype,
                      precision=_HIGHEST)


def _dominant(B, F_shape, dtype, n_iters, u0, method):
    """Dominant unit eigenvector of each Gram: exact eigh, or the squared
    power scheme from u0 (default: the normalized all-ones vector)."""
    if method == "eigh":
        return _eigh_dominant(B)
    if u0 is None:
        u0 = jnp.ones(F_shape[:2], dtype=dtype)
        u0 = u0 / jnp.sqrt(jnp.asarray(F_shape[1], dtype))
    return _power_iterate(B, u0, n_iters)


def _eigh_dominant(B: jnp.ndarray) -> jnp.ndarray:
    """Exact dominant eigenvector via batched eigh (parity/debug path)."""
    _, vecs = jnp.linalg.eigh(B)        # ascending eigenvalues
    u = vecs[..., -1]
    # canonicalize toward the nonnegative Perron orientation
    return u * jnp.where(jnp.sum(u, axis=-1, keepdims=True) < 0, -1.0, 1.0)


def masked_rank_one_uv(
    F: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    n_iters: int = 30,
    u0: Optional[jnp.ndarray] = None,
    method: str = "power",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scale-free rank-1 state: (u, v_raw = Aᵀu), no sigma.

    Inside the Lagrangian NMF-OA loop the estimate K·E = (u·s)·(Aᵀu/s)ᵀ
    == u ⊗ (Aᵀu) exactly — the scale cancels (exact up to the 1e-30 eps
    regularizer in ``masked_rank_one``'s divide, which is below f32/f64
    resolution for any nonzero s; at s=0, v=0 so both forms give est=0)
    — so the per-iteration
    Rayleigh quotient, sqrt and the (G, W)-sized divide of
    ``masked_rank_one`` are dead work on the loop's serial dependency
    chain.  Callers materialize K, E once after the loop via
    ``finish_rank_one``.
    """
    m = mask.astype(F.dtype)
    A = F * m[:, None, :]
    B = _gram(A)
    u = _dominant(B, F.shape, F.dtype, n_iters, u0, method)
    v = jnp.einsum("gpw,gp->gw", A, u, preferred_element_type=F.dtype,
                   precision=_HIGHEST)
    return u, v


def finish_rank_one(
    X: jnp.ndarray,
    mask: jnp.ndarray,
    u: jnp.ndarray,
    v: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Materialize (K, E) from a ``masked_rank_one_uv`` state: s from the
    Rayleigh quotient of X's Gram (identical op order to
    ``masked_rank_one``'s tail, so the result matches the per-iteration
    form bit-for-bit on the final iterate)."""
    m = mask.astype(X.dtype)
    A = X * m[:, None, :]
    B = _gram(A)
    Bu = _matvec(B, u)
    s = jnp.sqrt(jnp.maximum(jnp.einsum("gp,gp->g", u, Bu,
                                        precision=_HIGHEST), 0.0))
    return u * s[:, None], v / (s[:, None] + _EPS)


def masked_rank_one(
    F: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    n_iters: int = 30,
    u0: Optional[jnp.ndarray] = None,
    method: str = "power",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Rank-1 factorization K·E of each masked gene matrix.

    Args:
      F: (G, p, W) nonnegative coverage batch.
      mask: (G, W) active-column mask (bool or float).
      n_iters: power-iteration steps (ignored for method="eigh").
      u0: optional (G, p) warm-start unit vectors.
      method: "power" (device fast path) or "eigh" (exact, parity path).

    Returns:
      K: (G, p)  = u * s   (nonnegative for nonnegative input),
      E: (G, W)  = right singular vector scaled to unit norm, zero on
                   masked columns,
      u: (G, p)  unit left singular vector (for warm starts).

    Matches reference ``rank_one_approx`` (nmf.py:55-64) up to sign and
    iteration tolerance.
    """
    m = mask.astype(F.dtype)
    A = F * m[:, None, :]
    B = _gram(A)
    u = _dominant(B, F.shape, F.dtype, n_iters, u0, method)

    # Rayleigh quotient on B gives sigma^2; v = Aᵀu / sigma.
    Bu = _matvec(B, u)
    s2 = jnp.maximum(jnp.einsum("gp,gp->g", u, Bu, precision=_HIGHEST), 0.0)
    s = jnp.sqrt(s2)
    v = jnp.einsum("gpw,gp->gw", A, u, preferred_element_type=F.dtype,
                   precision=_HIGHEST)
    v = v / (s[:, None] + _EPS)

    K = u * s[:, None]
    return K, v, u


def outer_product(K: jnp.ndarray, E: jnp.ndarray) -> jnp.ndarray:
    """(G,p) x (G,W) -> (G,p,W) rank-1 reconstruction K·E."""
    return K[:, :, None] * E[:, None, :]


def masked_rowsum(X: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """(G,p,W) row sums over active columns -> (G,p)."""
    return jnp.einsum("gpw,gw->gp", X, mask.astype(X.dtype),
                      precision=_HIGHEST)
