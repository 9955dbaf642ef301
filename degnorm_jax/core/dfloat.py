"""Double-float (two-float32) arithmetic for the device-resident outer loop.

The device loop computes in float32, but the DegNorm outer-loop update
(reference ``nmf.py:574-595``) is precision-sensitive: its column sums,
medians and cumulative scale-factor products feed back into the next
iteration's kernel inputs, and plain-f32 rounding (~1e-6 relative per op)
measurably perturbs borderline trim decisions over 5 iterations (the
round-3 device loop's adjusted-count maxrel vs the f64 host loop was
4e-2 — BENCHMARKS.md).  These arrays are O(n·p) kilobytes, so we can
afford compensated arithmetic: each value is an UNEVALUATED SUM of two
f32s ``hi + lo`` with ``|lo| <= ulp(hi)/2`` — ~49 bits of significand,
within a hair of float64's 53.  The error-free transformations (Knuth
two-sum, Dekker split/two-prod) rely only on IEEE-754 round-to-nearest
f32 ops, which XLA preserves (it performs no unsafe reassociation of
explicit arithmetic).

Cost: each df op is ~4-20 f32 elementwise ops on (n, p)/(p,)-sized arrays —
microseconds per outer iteration, invisible next to the bucket kernels.

References: Dekker (1971), "A floating-point technique for extending the
available precision"; the QD library's df64 algorithms (Hida, Li, Bailey
2001).  The reference implementation simply runs numpy float64 on host
(``nmf.py:574-595``); a native-f64 outer update on the GPU could replace
this module (ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class DF(NamedTuple):
    """value ≈ hi + lo (unevaluated), |lo| <= ulp(hi)/2 after renorm."""
    hi: jnp.ndarray
    lo: jnp.ndarray


# ---- error-free transformations (f32, IEEE round-to-nearest) ------------
#
# CRITICAL: every EFT wraps its pivot intermediates in
# lax.optimization_barrier.  XLA's algebraic simplifier performs the
# real-arithmetic rewrite (a+b)-a -> b REGARDLESS of fast-math flags
# (verified on the CPU backend: jitted two-sum compensation
# terms collapse to zero while eager mode is exact), which silently
# deletes the compensation this module exists for.  The barrier makes the
# rounded intermediate opaque to the pattern-matcher; it has no runtime
# cost beyond lost fusion on these kilobyte-sized arrays.  This is the
# documented JAX escape hatch for exactly this class of algorithm (the
# optimization_barrier docs name compensated summation).

def _b(x):
    import jax
    return jax.lax.optimization_barrier(x)


def _quick_two_sum(a, b):
    """(s, e) with s = fl(a+b), s+e == a+b exactly; requires |a| >= |b|."""
    s = _b(a + b)
    return s, b - (s - a)


def _two_sum(a, b):
    """(s, e) with s = fl(a+b), s+e == a+b exactly; no magnitude order."""
    s = _b(a + b)
    bb = _b(s - a)
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Dekker split of an f32 into two 12-bit-significand halves."""
    c = _b(jnp.asarray(4097.0, a.dtype) * a)      # 2^12 + 1
    t = _b(c - a)
    hi = _b(c - t)
    return hi, a - hi


def _two_prod(a, b):
    """(p, e) with p = fl(a*b), p+e == a*b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---- construction / conversion ------------------------------------------

def lift(x) -> DF:
    """Exact f32 -> df."""
    return DF(x, jnp.zeros_like(x))


def const(v, like) -> DF:
    """Scalar python constant -> df broadcast like ``like``."""
    x = jnp.full_like(like, v)
    return DF(x, jnp.zeros_like(x))


def to_f32(x: DF) -> jnp.ndarray:
    """Round the df value to the nearest f32 (hi absorbs lo)."""
    return x.hi + x.lo


def from_f64_np(x: np.ndarray):
    """Host-side split of a float64 array into (hi, lo) float32 numpy
    arrays with hi + lo == x to f64-rounding accuracy."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def to_f64_np(hi, lo) -> np.ndarray:
    """Host-side recombination into float64."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


# ---- arithmetic ----------------------------------------------------------

def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def add(x: DF, y: DF) -> DF:
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DF(*_quick_two_sum(s, e))


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def mul(x: DF, y: DF) -> DF:
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF(*_quick_two_sum(p, e))


def div(x: DF, y: DF) -> DF:
    """Long division: one f32 quotient digit + one compensated correction
    (relative error ~2^-45 — the df64 class).  q1 is barriered so the
    simplifier cannot fold the residual's y*q1 back into x."""
    q1 = _b(x.hi / y.hi)
    r = sub(x, mul(y, DF(q1, jnp.zeros_like(q1))))
    q2 = (r.hi + r.lo) / y.hi
    return DF(*_quick_two_sum(q1, q2))


def where(cond, x: DF, y: DF) -> DF:
    return DF(jnp.where(cond, x.hi, y.hi), jnp.where(cond, x.lo, y.lo))


def scale_exact(x: DF, s: float) -> DF:
    """Multiply by an exact power of two (e.g. 0.5) — error-free."""
    return DF(x.hi * s, x.lo * s)


# ---- reductions ----------------------------------------------------------

def dsum(x: DF, axis: int = 0) -> DF:
    """Compensated sum along ``axis``: a binary tree of df adds.  Each
    element passes through log2(n) compensated combines, so the error is
    ~log2(n) * 2^-47 relative — effectively exact for f64 purposes.  All
    shapes static; log2(n) vectorized levels (no serial scan)."""
    hi = jnp.moveaxis(x.hi, axis, 0)
    lo = jnp.moveaxis(x.lo, axis, 0)
    n = hi.shape[0]
    if n == 0:
        return DF(jnp.zeros(hi.shape[1:], hi.dtype),
                  jnp.zeros(hi.shape[1:], hi.dtype))
    n2 = 1 << max(0, int(n - 1).bit_length())
    if n2 != n:
        pad = [(0, n2 - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    cur = DF(hi, lo)
    while cur.hi.shape[0] > 1:
        h = cur.hi.shape[0] // 2
        cur = add(DF(cur.hi[:h], cur.lo[:h]), DF(cur.hi[h:], cur.lo[h:]))
    return DF(cur.hi[0], cur.lo[0])


def median_1d(x: DF) -> DF:
    """Median of a 1-D df vector, matching ``np.median`` semantics (mean
    of the two middle elements for even length).  Ordering is the true df
    order: lexicographic on (hi, lo) — for renormalized pairs
    hi1 < hi2 or (hi1 == hi2 and lo1 < lo2)  ⇔  value1 < value2."""
    p = x.hi.shape[0]
    order = jnp.lexsort((x.lo, x.hi))
    hi = x.hi[order]
    lo = x.lo[order]
    if p % 2 == 1:
        return DF(hi[p // 2], lo[p // 2])
    a = DF(hi[p // 2 - 1], lo[p // 2 - 1])
    b = DF(hi[p // 2], lo[p // 2])
    return scale_exact(add(a, b), 0.5)


def dmax(x: DF, axis: int = -1) -> DF:
    """Elementwise-max reduction in true df order."""
    hi = jnp.moveaxis(x.hi, axis, 0)
    lo = jnp.moveaxis(x.lo, axis, 0)

    def pick(a: DF, b: DF) -> DF:
        take_b = (b.hi > a.hi) | ((b.hi == a.hi) & (b.lo > a.lo))
        return where(take_b, b, a)

    cur = DF(hi, lo)
    n = cur.hi.shape[0]
    n2 = 1 << max(0, int(n - 1).bit_length())
    if n2 != n:
        pad = [(0, n2 - n)] + [(0, 0)] * (hi.ndim - 1)
        neg_inf = jnp.finfo(hi.dtype).min
        cur = DF(jnp.pad(cur.hi, pad, constant_values=neg_inf),
                 jnp.pad(cur.lo, pad, constant_values=0))
    while cur.hi.shape[0] > 1:
        h = cur.hi.shape[0] // 2
        cur = pick(DF(cur.hi[:h], cur.lo[:h]), DF(cur.hi[h:], cur.lo[h:]))
    return DF(cur.hi[0], cur.lo[0])
