"""Batched masked baseline selection — the per-gene trimming loop of DegNorm
as a single fixed-shape device kernel.

Device re-design of reference ``GeneNMFOA.baseline_selection``
(``degnorm/nmf.py:189-372``).  The reference runs a data-dependent Python
``while`` per gene, physically deleting trim-bin columns with ``np.delete``
(nmf.py:292-295).  Here a whole (G, p, W) bucket advances together through a
bounded ``lax.while_loop`` (at most ``bins - min_bins`` = 16 rounds,
SURVEY.md §2.2), with every early-exit of the reference replicated as a
per-gene ``active`` flag:

  * exact-approximation exit (nmf.py:286-287)
  * svds ValueError on < 2 surviving columns (nmf.py:306-310)
  * all-zero fitted sample (nmf.py:315-316)
  * bin-count / gene-length floors (nmf.py:323-324)

Column deletion becomes bin masking: trim bins are consecutive runs of the
high-coverage column *ranks* with chunk size ceil(n/bins) (exactly the
reference's ``split_into_chunks``, utils.py:176-192, which may yield fewer
than ``bins`` bins), and a dropped bin simply deactivates its columns.
Because columns only ever leave as whole bins, each bin's membership and
count are loop invariants.

A clip subtlety preserved from the reference: the residuals of round r+1 are
computed against the estimate of round r, which was clipped up to F at
nmf.py:318 — but the round-1 residuals use the *unclipped* initial estimate
(nmf.py:247).  We carry a per-gene ``clipped`` flag for this.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.core.linalg import masked_rowsum, outer_product
from degnorm_jax.core.nmf import nmf_masked
from degnorm_jax.ops.nmf_gpu import kernel_enabled

_NEG_INF = -jnp.inf

# estimate materialization kinds (see BucketResult.est_kind)
EST_INPUT = 0    # estimate is the (scale-adjusted) input F itself
EST_CLIP = 1     # estimate = max(K·E, F) on valid columns
EST_RAW = 2      # estimate = K·E unclipped


class BucketResult(NamedTuple):
    rho: jnp.ndarray          # (G, p) DI scores, pre-clip
    ran_bs: jnp.ndarray       # (G,) bool: entered the trim loop this iteration
    est_K: jnp.ndarray        # (G, p) final estimate row factor
    est_E: jnp.ndarray        # (G, W) final estimate column factor
    est_kind: jnp.ndarray     # (G,) int8, one of EST_INPUT/EST_CLIP/EST_RAW
    bailed: jnp.ndarray       # (G,) bool: returned defaults before NMF
    n_hi: jnp.ndarray         # (G,) int32 high-coverage column count
    rounds_active: jnp.ndarray  # (G,) int32 trim rounds each gene stayed
                                # active (drives cross-iteration gene
                                # reordering by exit round)


class _TrimState(NamedTuple):
    K: jnp.ndarray            # (G, p)
    E: jnp.ndarray            # (G, W)
    rho: jnp.ndarray          # (G, p)
    u: jnp.ndarray            # (G, p) left vector (cold-resume warm start)
    bin_active: jnp.ndarray   # (G, B) bool
    n_hi: jnp.ndarray         # (G,) int32 surviving column count
    n_bins: jnp.ndarray      # (G,) int32 surviving bin count
    active: jnp.ndarray       # (G,) bool still trimming
    ran_bs: jnp.ndarray       # (G,) bool
    clipped: jnp.ndarray      # (G,) bool latest estimate was clipped
    rounds: jnp.ndarray       # () int32
    rounds_active: jnp.ndarray  # (G,) int32


def _floor_abs_k(K: jnp.ndarray) -> jnp.ndarray:
    """abs(K) with entries < 1e-5 replaced by the smallest valid entry
    (reference nmf.py:329-330,361-362).  If no entry is valid the reference
    crashes on an empty min; we clamp to 1e-5 instead."""
    Kq = jnp.abs(K)
    valid = Kq >= 1e-5
    big = jnp.where(valid, Kq, jnp.inf)
    min_valid = jnp.min(big, axis=1)
    min_valid = jnp.where(jnp.isfinite(min_valid), min_valid, 1e-5)
    return jnp.where(valid, Kq, min_valid[:, None])


def _envelope(F: jnp.ndarray, Kq: jnp.ndarray, col_mask_f: jnp.ndarray) -> jnp.ndarray:
    """E[w] = max_j F[j, w] / Kq[j] on active columns, 0 elsewhere
    (reference nmf.py:333,363)."""
    return jnp.max(F / Kq[:, :, None], axis=1) * col_mask_f


def baseline_select_bucket(
    F: jnp.ndarray,
    len_mask: jnp.ndarray,
    nmf_cfg: NMFConfig,
    eng_cfg: EngineConfig,
    ds_start: Optional[jnp.ndarray] = None,
    with_estimates: bool = True,
) -> BucketResult:
    """Run baseline selection for every gene in a padded bucket.

    Args:
      F: (G, p, W) scale-adjusted coverage, zero beyond each gene's length.
      len_mask: (G, W) bool validity mask (True on the first L_i columns).
      nmf_cfg / eng_cfg: static configuration (hashable dataclasses).
      ds_start: (G,) int32 systematic-sampling start offsets in
        [0, downsample_rate); required iff downsample_rate > 1.  The
        reference draws these from a thread-shared RNG (racy — SURVEY.md
        §2.2); we take deterministic per-gene offsets instead.
    """
    G, p, W = F.shape
    dtype = F.dtype
    B = nmf_cfg.bins
    lm_f = len_mask.astype(dtype)
    Fm = F * lm_f[:, None, :]

    nmf_kwargs = dict(
        nmf_iter=nmf_cfg.nmf_iter,
        power_iters_cold=eng_cfg.power_iters_cold,
        power_iters_warm=eng_cfg.power_iters_warm,
        method=eng_cfg.rank1_method,
        use_gpu_kernel=kernel_enabled(eng_cfg),
        pallas_interpret=eng_cfg.pallas_interpret,
        nmf_tol=eng_cfg.nmf_tol,
    )

    # ---- high-coverage mask (nmf.py:66-76,220) ----
    colmax = jnp.max(Fm, axis=1)                       # (G, W)
    gmax = jnp.max(colmax, axis=1)                     # (G,)
    hi = (colmax > 0.1 * gmax[:, None]) & len_mask

    # ---- systematic downsampling (nmf.py:222-227,408-426) ----
    if nmf_cfg.downsample_rate > 1:
        if ds_start is None:
            raise ValueError("ds_start required when downsampling")
        idx = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
        ds_mask = (idx % nmf_cfg.downsample_rate) == ds_start[:, None]
        hi = hi & ds_mask

    hi_f = hi.astype(dtype)
    n_hi = jnp.sum(hi, axis=1).astype(jnp.int32)       # (G,)

    # ---- bail-outs before NMF (nmf.py:232-242) ----
    bail_low = n_hi < nmf_cfg.effective_min_high_coverage
    rowsum_start = masked_rowsum(F, hi_f)              # (G, p)
    bail_zero_row = jnp.sum(rowsum_start > 0, axis=1) < p

    # ---- initial NMF, unclipped DI scores (nmf.py:245-258) ----
    K0, E0, u0 = nmf_masked(F, hi, gene_active=~(bail_low | bail_zero_row),
                            **nmf_kwargs)
    est_rs0 = K0 * jnp.sum(E0, axis=1)[:, None]
    rho0 = 1 - rowsum_start / (est_rs0 + 1)
    bail_nonconv = jnp.median(1 - rho0, axis=1) > 1
    bailed = bail_low | bail_zero_row | bail_nonconv

    skip = bool(nmf_cfg.skip_baseline_selection)
    entered = (
        (~bailed)
        & (n_hi >= nmf_cfg.min_gene_len)
        & (jnp.min(rho0, axis=1) <= 0.2)
        & (not skip)
    )

    # ---- trim bins over column ranks (utils.py:176-192, nmf.py:269-271) ----
    csize = jnp.maximum((n_hi + B - 1) // B, 1)        # (G,)
    rank = jnp.cumsum(hi, axis=1).astype(jnp.int32) - 1
    bin_id = jnp.where(hi, rank // csize[:, None], B)  # B == padding sentinel
    bin_ids = jnp.arange(B, dtype=jnp.int32)
    # bins are rank-contiguous runs of length csize: closed-form counts.
    bin_count = jnp.clip(
        n_hi[:, None] - bin_ids[None, :] * csize[:, None], 0, csize[:, None]
    ).astype(dtype)                                    # (G, B)
    n_bins0 = ((n_hi + csize - 1) // csize).astype(jnp.int32)
    bin_active0 = bin_ids[None, :] < n_bins0[:, None]

    def col_active_from(bin_active):
        # B unrolled compare-and-or passes instead of a (G, W) gather
        # (take_along_axis); this runs twice per trim round.  bin_id == b
        # only holds on hi columns (padding uses the B sentinel), so the
        # hi mask is implicit.
        act = jnp.zeros_like(hi)
        for b in range(B):
            act = act | ((bin_id == b) & bin_active[:, b:b + 1])
        return act

    def per_bin_sums(res):
        # res: (G, W) already masked to active columns; bins are few (20),
        # so B independent masked reductions instead of a scatter.
        return jnp.stack(
            [jnp.sum(res * (bin_id == b), axis=1) for b in range(B)], axis=1)

    state0 = _TrimState(
        K=K0, E=E0, rho=rho0, u=u0,
        bin_active=bin_active0,
        n_hi=n_hi, n_bins=n_bins0,
        active=entered & (jnp.max(rho0, axis=1) > 0.1),   # nmf.py:273
        ran_bs=jnp.zeros((G,), bool),
        clipped=jnp.zeros((G,), bool),
        rounds=jnp.zeros((), jnp.int32),
        rounds_active=jnp.zeros((G,), jnp.int32),
    )

    def cond(st: _TrimState):
        return jnp.any(st.active) & (st.rounds < nmf_cfg.max_trim_rounds)

    def body(st: _TrimState) -> _TrimState:
        ran_bs = st.ran_bs | st.active                  # nmf.py:276
        col_act = col_active_from(st.bin_active)
        ca_f = col_act.astype(dtype)

        # worst squared relative residual per column (nmf.py:280-283);
        # round-1 uses the unclipped estimate, later rounds the clipped one.
        KE = outer_product(st.K, st.E)
        KE = jnp.where(st.clipped[:, None, None], jnp.maximum(KE, Fm), KE)
        z = (KE - Fm) / (Fm + 1)
        res = jnp.max(z * z, axis=1) * ca_f
        ss_sum = per_bin_sums(res)
        ss_r = ss_sum / jnp.maximum(bin_count, 1.0)
        ss_masked = jnp.where(st.bin_active, ss_r, _NEG_INF)

        perfect = jnp.max(ss_masked, axis=1) == 0.0     # nmf.py:286-287
        proceed = st.active & ~perfect

        drop = jnp.argmax(ss_masked, axis=1)            # first max, like nanargmax
        drop_onehot = bin_ids[None, :] == drop[:, None]
        bin_active = jnp.where(
            proceed[:, None], st.bin_active & ~drop_onehot, st.bin_active)
        dropped = jnp.sum(jnp.where(drop_onehot, bin_count, 0), axis=1)
        n_hi_new = jnp.where(proceed, st.n_hi - dropped.astype(jnp.int32), st.n_hi)
        n_bins_new = jnp.where(proceed, st.n_bins - 1, st.n_bins)

        # svds would raise ValueError below 2 columns (nmf.py:306-310):
        # stop WITHOUT refreshing factors or rho.
        run_nmf = proceed & (n_hi_new >= 2)
        col_act_new = col_active_from(bin_active)

        # Cold rank-1 resumed from the previous round's left vector at the
        # reduced power_iters_resume count (same unique Perron target —
        # EngineConfig.power_iters_resume).  Genes that left the loop
        # (run_nmf false) cost nothing on the GPU kernel.
        resume_kwargs = dict(nmf_kwargs,
                             power_iters_cold=eng_cfg.power_iters_resume
                             or eng_cfg.power_iters_cold)
        Kn, En, un = nmf_masked(F, col_act_new, gene_active=run_nmf,
                                u0=st.u, **resume_kwargs)
        est_rs = Kn * jnp.sum(En, axis=1)[:, None]
        zero_row = jnp.min(est_rs, axis=1) == 0.0       # nmf.py:315-316
        update_rho = run_nmf & ~zero_row

        # clip up to F, recompute DI (nmf.py:318-321)
        can_f = col_act_new.astype(dtype)
        KE_clip = jnp.maximum(outer_product(Kn, En), Fm)
        rs_F = masked_rowsum(F, can_f)
        rs_KE = masked_rowsum(KE_clip, can_f)
        rho_new = 1 - rs_F / (rs_KE + 1)

        K = jnp.where(run_nmf[:, None], Kn, st.K)
        E = jnp.where(run_nmf[:, None], En, st.E)
        u = jnp.where(run_nmf[:, None], un, st.u)
        rho = jnp.where(update_rho[:, None], rho_new, st.rho)
        clipped = st.clipped | update_rho

        floor_hit = (n_bins_new <= nmf_cfg.min_bins) | (
            n_hi_new < nmf_cfg.min_gene_len)            # nmf.py:323-324
        active = update_rho & ~floor_hit & (
            jnp.max(rho_new, axis=1) > 0.1)             # nmf.py:273

        return _TrimState(K=K, E=E, rho=rho, u=u, bin_active=bin_active,
                          n_hi=n_hi_new, n_bins=n_bins_new, active=active,
                          ran_bs=ran_bs, clipped=clipped,
                          rounds=st.rounds + 1,
                          rounds_active=st.rounds_active
                          + st.active.astype(jnp.int32))

    st = jax.lax.while_loop(cond, body, state0)
    return _finalize_bucket(F, Fm, lm_f, hi_f, len_mask, K0, E0, rho0,
                            rowsum_start, n_hi, bailed, entered, st,
                            dtype, with_estimates)


def _finalize_bucket(F, Fm, lm_f, hi_f, len_mask, K0, E0, rho0,
                     rowsum_start, n_hi, bailed, entered, st,
                     dtype, with_estimates) -> BucketResult:
    """Post-trim-loop refit / revert (nmf.py:327-365) (only st.K /
    st.rho / st.ran_bs / st.rounds_active are consumed from the loop
    state)."""
    G, p, W = F.shape

    # ---- post-loop refit / revert (nmf.py:327-353) ----
    conv = jnp.max(st.rho, axis=1) < 0.2
    Kq = _floor_abs_k(st.K)
    E_env = _envelope(F, Kq, hi_f)
    est_rs_env = Kq * jnp.sum(E_env, axis=1)[:, None]
    rho_env = 1 - rowsum_start / (est_rs_env + 1)
    inflate = jnp.max(rho_env, axis=1) > 0.9

    use_env = entered & conv & ~inflate
    use_revert = entered & (~conv | inflate)

    est0_clip_rs = masked_rowsum(
        jnp.maximum(outer_product(K0, E0), Fm), hi_f)
    rho_rev = 1 - rowsum_start / (est0_clip_rs + 1)

    rho_out = jnp.where(
        use_env[:, None], rho_env,
        jnp.where(use_revert[:, None], rho_rev,
                  jnp.where(bailed[:, None], jnp.zeros_like(rho0), rho0)))

    # ---- estimate factors for the output contract (nmf.py:355-365) ----
    # "latest K" for the full-width refit: envelope K for converged genes,
    # the pre-trim K0 otherwise.
    K_fin = jnp.where(use_env[:, None], Kq, K0)
    E_fin = jnp.where(use_env[:, None], E_env, E0)

    L = jnp.sum(len_mask, axis=1).astype(jnp.int32)
    needs_fw = (~bailed) & (n_hi < L)
    Kq2 = _floor_abs_k(K_fin)
    est_K = jnp.where(needs_fw[:, None], Kq2, K_fin)
    est_kind = jnp.where(
        bailed, EST_INPUT,
        jnp.where(needs_fw | use_revert, EST_CLIP, EST_RAW)
    ).astype(jnp.int8)
    if with_estimates:
        E_fw = _envelope(F, Kq2, lm_f)
        est_E = jnp.where(needs_fw[:, None], E_fw, E_fin)
    else:
        # intermediate iterations only consume rho/flags; returning a
        # zero-width E avoids shipping a (G, W) array off-device per call
        est_E = jnp.zeros((G, 0), dtype)

    return BucketResult(rho=rho_out, ran_bs=st.ran_bs, est_K=est_K,
                        est_E=est_E, est_kind=est_kind, bailed=bailed,
                        n_hi=n_hi, rounds_active=st.rounds_active)


def materialize_estimate(F_adj, length, est_K, est_E, est_kind):
    """Rebuild one gene's dense estimated coverage matrix (p x L) from the
    factor form returned by ``baseline_select_bucket`` (host-side, numpy).
    ``F_adj`` is the scale-adjusted input (p x L)."""
    import numpy as np
    if est_kind == EST_INPUT:
        return np.asarray(F_adj[:, :length])
    KE = np.outer(est_K, est_E[:length])
    if est_kind == EST_CLIP:
        return np.maximum(KE, F_adj[:, :length])
    return KE
