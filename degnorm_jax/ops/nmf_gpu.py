"""Pallas (Triton route) kernel for the NMF-OA Lagrangian loop on NVIDIA GPUs.

The XLA loop (core/nmf.py) runs the whole (G, p, W) bucket in lockstep and
re-reads and re-writes the bucket in device memory several times per inner
iteration (the clipped multiplier update, the Gram contraction, v = Xᵀu).
Here one program owns one gene for all ``nmf_iter`` iterations:

  * each iteration is ONE sweep over the gene's W columns in chunks of
    ``chunk`` columns: v = Xᵀu on the chunk, the clipped X-form update,
    the chunk's store, and the chunk's contribution to the p x p Gram;
  * the Gram, the power iteration and u stay in registers; A0 and X are
    this program's private working set (2·p·W·4 bytes, 64 KB at p=8,
    W=1024), so their re-reads hit the SM's L1 or the L2;
  * a gene with ``gene_active`` false returns at once with zero outputs,
    which is what lets the trim loop pay only for the genes still trimming.

Numerics follow core/nmf.py's scale-free (u, v) loop step for step: the
cold squared-operator power iteration (optionally resumed from ``u0``), the
warm restart each iteration, the X-form clipped update and
``finish_rank_one``.  Sums run in a
different order than XLA's, so results agree to f32 rounding, not bitwise.
Products are plain f32 multiply-adds: no TF32, no bf16.

Samples are padded to a power of two with zero rows (Triton block shapes
are powers of two).  A zero row has zero Gram entries and a zero start
vector entry, so it stays exactly zero and leaves the real rows unchanged.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_EPS = 1e-30
# Largest padded sample count the kernel takes: at P = 32 it lost to the
# XLA loop on the H100 (PERF.md).
MAX_SAMPLES = 16
# Largest per-gene state, in padded p·W elements, the kernel takes: A0 and
# X of one gene (2·P·W·4 bytes) must stay an on-chip (L1/L2) working set.
MAX_STATE = 32768
# Elements of the (P, P, chunk) Gram accumulator a program carries, and
# warps per program: small programs, many of them resident on each SM,
# measured fastest on the H100 (PERF.md).
_GRAM_ELEMS = 4096
_NUM_WARPS = 2


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def on_gpu() -> bool:
    """The one platform check: is JAX's default backend a GPU?"""
    return jax.default_backend() == "gpu"


def kernel_enabled(eng_cfg) -> bool:
    """True when the fit routes NMF calls through this kernel: the switch
    ``EngineConfig.use_pallas`` is on and the platform is a GPU, or the
    kernel runs in the Pallas interpreter (``pallas_interpret``, the CPU
    test mode).  On CPU the engine otherwise uses the XLA loop."""
    return bool(eng_cfg.use_pallas) and (
        bool(eng_cfg.pallas_interpret) or on_gpu())


def kernel_supported(shape, dtype, *, method: str = "power",
                     nmf_tol: float = 0.0) -> bool:
    """The kernel's gate.  Admits float32 buckets whose width is a power of
    two, whose padded sample count is at most MAX_SAMPLES and whose padded
    per-gene state P·W is at most MAX_STATE elements, at the reference
    semantics (power iteration, fixed ``nmf_iter``).  Everything else
    (wider buckets, the exact-width outlier buckets, ``nmf_tol > 0``,
    ``rank1_method="eigh"``, float64) takes the XLA loop."""
    _, p, W = shape
    P = next_pow2(p)
    return (jnp.dtype(dtype) == jnp.float32
            and method == "power" and nmf_tol <= 0
            and W >= 16 and W == next_pow2(W)
            and P <= MAX_SAMPLES and P * W <= MAX_STATE)


def _chunk(P: int, W: int) -> int:
    return int(min(W, max(8, _GRAM_ELEMS // (P * P))))


def _matvec(B, u):
    return jnp.sum(B * u[None, :], axis=1)


def _normalized(w, u):
    nrm = jnp.sqrt(jnp.sum(w * w))
    return jnp.where(nrm > _EPS, w / (nrm + _EPS), u)


def _scaled(B):
    return B / (jnp.max(jnp.abs(B)) + _EPS)


def _power(B, u, n_iters: int):
    """core.linalg._power_iterate: squared normalized operator, two B²
    steps per body, max(1, n_iters // 4) bodies."""
    Bn = _scaled(B)
    # B2 = Bn·Bn, written as Bn·Bnᵀ (Bn is symmetric, so the values are
    # the same): reducing the middle axis of Bn[:, :, None] * Bn[None]
    # is the pattern Triton rewrites into a TF32 dot once P >= 16.
    B2 = jnp.sum(Bn[:, None, :] * Bn[None, :, :], axis=2)

    def body(_, u):
        return _normalized(_matvec(B2, _matvec(B2, u)), u)

    return jax.lax.fori_loop(0, max(1, n_iters // 4), body, u)


def _kernel(act_ref, a0_ref, u0_ref, k_ref, e_ref, u_ref, x_ref, *,
            nmf_iter: int, power_cold: int, power_warm: int,
            chunk: int, step: float, interpret: bool):
    P, W = a0_ref.shape
    n_chunks = W // chunk
    active = act_ref[0] > 0

    def cols(c):
        return pl.ds(pl.multiple_of(c * chunk, chunk), chunk)

    def gram_zero():
        return jnp.zeros((P, P, chunk), jnp.float32)

    def barrier():
        # X chunks written by one thread are read back by another in the
        # next sweep; the interpreter runs in program order and has no
        # barrier primitive.
        if not interpret:
            pltriton.debug_barrier()

    @pl.when(jnp.logical_not(active))
    def _():
        k_ref[...] = jnp.zeros((P,), jnp.float32)
        u_ref[...] = jnp.zeros((P,), jnp.float32)

        def zero_e(c, carry):
            e_ref[cols(c)] = jnp.zeros((chunk,), jnp.float32)
            return carry

        jax.lax.fori_loop(0, n_chunks, zero_e, 0)

    @pl.when(active)
    def _():
        # cold rank-1 of A0; X starts as A0 (X-form: X = A0 + lambda)
        def copy_gram(c, acc):
            a = a0_ref[:, cols(c)]
            x_ref[:, cols(c)] = a
            return acc + a[:, None, :] * a[None, :, :]

        B = jnp.sum(jax.lax.fori_loop(0, n_chunks, copy_gram, gram_zero()),
                    axis=2)
        u = _power(B, u0_ref[...], power_cold)
        barrier()

        def iteration(_, carry):
            u, _B = carry

            def sweep(c, acc):
                x = x_ref[:, cols(c)]
                a = a0_ref[:, cols(c)]
                v = jnp.sum(x * u[:, None], axis=0)
                est = u[:, None] * v[None, :]
                x = jnp.maximum(x - step * (est - a), a)
                x_ref[:, cols(c)] = x
                return acc + x[:, None, :] * x[None, :, :]

            B = jnp.sum(jax.lax.fori_loop(0, n_chunks, sweep, gram_zero()),
                        axis=2)
            barrier()
            u = _power(B, u, power_warm)
            return u, B

        u, B = jax.lax.fori_loop(0, nmf_iter, iteration, (u, B))

        # finish_rank_one: s from the Rayleigh quotient of the last Gram
        s = jnp.sqrt(jnp.maximum(jnp.sum(u * _matvec(B, u)), 0.0))
        k_ref[...] = u * s
        u_ref[...] = u

        def finish(c, carry):
            v = jnp.sum(x_ref[:, cols(c)] * u[:, None], axis=0)
            e_ref[cols(c)] = v / (s + _EPS)
            return carry

        jax.lax.fori_loop(0, n_chunks, finish, 0)


@functools.partial(jax.jit, static_argnames=(
    "nmf_iter", "power_iters_cold", "power_iters_warm", "interpret"))
def nmf_masked_gpu(
    F: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    nmf_iter: int,
    power_iters_cold: int = 30,
    power_iters_warm: int = 6,
    gene_active: Optional[jnp.ndarray] = None,
    u0: Optional[jnp.ndarray] = None,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Drop-in for core.nmf.nmf_masked (method="power", nmf_tol=0) on a
    bucket that ``kernel_supported`` admits.  Returns (K, E, u); genes with
    ``gene_active`` false get all-zero outputs."""
    G, p, W = F.shape
    P = next_pow2(p)
    chunk = _chunk(P, W)
    A0 = F * mask.astype(F.dtype)[:, None, :]
    if u0 is None:
        u0 = (jnp.ones((G, p), F.dtype)
              / jnp.sqrt(jnp.asarray(p, F.dtype)))
    if P != p:
        A0 = jnp.pad(A0, ((0, 0), (0, P - p), (0, 0)))
        u0 = jnp.pad(u0, ((0, 0), (0, P - p)))
    act = (jnp.ones((G, 1), jnp.int32) if gene_active is None
           else gene_active.astype(jnp.int32)[:, None])
    step = float(np.float32(1.0) / np.sqrt(np.float32(nmf_iter)))
    kernel = functools.partial(
        _kernel, nmf_iter=nmf_iter, power_cold=power_iters_cold,
        power_warm=power_iters_warm,
        chunk=chunk, step=step, interpret=interpret)
    row = pl.BlockSpec((None, P), lambda g: (g, 0))
    K, E, u, _ = pl.pallas_call(
        kernel,
        grid=(G,),
        in_specs=[pl.BlockSpec((None, 1), lambda g: (g, 0)),
                  pl.BlockSpec((None, P, W), lambda g: (g, 0, 0)),
                  row],
        out_specs=(row,
                   pl.BlockSpec((None, W), lambda g: (g, 0)),
                   row,
                   pl.BlockSpec((None, P, W), lambda g: (g, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((G, P), F.dtype),
                   jax.ShapeDtypeStruct((G, W), F.dtype),
                   jax.ShapeDtypeStruct((G, P), F.dtype),
                   jax.ShapeDtypeStruct((G, P, W), F.dtype)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="nmf_oa_gene",
    )(act, A0, u0.astype(F.dtype))
    return K[:, :p], E, u[:, :p]
