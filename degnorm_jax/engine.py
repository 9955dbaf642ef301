"""DegNormEngine — the device equivalent of reference ``GeneNMFOA``.

Public API mirrors ``GeneNMFOA.run(cov_dat, reads_dat)`` (nmf.py:483-601):
an ordered {gene: (p x L_i) coverage matrix} mapping plus an (n x p) read
count matrix in, DI scores / adjusted counts / coverage estimates out.

Execution model (SURVEY.md §7.1-7.2):
  * genes are packed into padded length buckets (data/buckets.py);
  * per DegNorm iteration, each bucket runs ONE jitted device kernel
    (core/baseline.py) that performs the whole NMF-OA + baseline-selection
    trim loop for all its genes at once — scale adjustment included, so
    bucket arrays stay device-resident across iterations;
  * the tiny cross-gene reductions (medians, column sums) run on host in
    float64 (core/degnorm.py);
  * gene-data-parallel sharding over a device mesh shards the G axis of
    every bucket (parallel/), replacing the reference's MPI layer.
"""
from __future__ import annotations

import functools
from typing import List, Mapping, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.core import degnorm as outer
from degnorm_jax.core.baseline import (
    BucketResult, baseline_select_bucket, materialize_estimate)
from degnorm_jax.core.nmf import ratio_svd_rowsums
from degnorm_jax.data.buckets import GeneBucket, pack_buckets


def _gene_spec(mesh_axis, x):
    from jax.sharding import PartitionSpec as P
    return P(mesh_axis, *([None] * (x.ndim - 1)))


def _shard_map_genes(fn, mesh, mesh_axis, gene_args, repl_args):
    """Run a fully gene-parallel function under shard_map: every gene_arg
    shards its leading axis, repl_args replicate, every output leaf is
    gene-leading.  This hands the GPU kernel LOCAL per-device shapes —
    GSPMD cannot partition an opaque custom call, so without this a
    sharded bucket would replicate it."""
    from jax.sharding import PartitionSpec as P
    out_shapes = jax.eval_shape(fn, *gene_args, *repl_args)
    in_specs = tuple(_gene_spec(mesh_axis, a) for a in gene_args) + tuple(
        P() for _ in repl_args)
    out_specs = jax.tree.map(lambda s: _gene_spec(mesh_axis, s), out_shapes)
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)(
        *gene_args, *repl_args)


def _data_fingerprint(cov_mats, n) -> tuple:
    """Content-derived dataset fingerprint for the reuse_device_data guard.

    Python id()s are recycled after gc, so a freed dataset replaced by a
    same-gene-count one at reused addresses could silently pass an
    identity-based check; shapes plus edge-column sums of the first/last
    matrices are cheap (O(p) each) and content-based instead."""
    if not cov_mats:
        return (n, 0)
    f0, f1 = cov_mats[0], cov_mats[-1]
    total_w = sum(int(F.shape[1]) for F in cov_mats)
    return (n, len(cov_mats), total_w, f0.shape, f1.shape,
            float(np.asarray(f0[:, 0]).sum()),
            float(np.asarray(f0[:, -1]).sum()),
            float(np.asarray(f1[:, 0]).sum()),
            float(np.asarray(f1[:, -1]).sum()))


def _seqpar_safe(eng_cfg: EngineConfig, column_sharded: bool) -> EngineConfig:
    """Column-sharded (seqpar) buckets must not route into the GPU kernel:
    the pallas_call is an opaque custom call GSPMD cannot partition along
    the sharded position axis (it would replicate the one bucket that was
    sharded precisely because it is huge).  The XLA lowering shards
    transparently."""
    if not column_sharded:
        return eng_cfg
    import dataclasses as _dc
    return _dc.replace(eng_cfg, use_pallas=False)


@functools.partial(jax.jit,
                   static_argnames=("nmf_cfg", "eng_cfg", "with_estimates",
                                    "mesh", "mesh_axis", "column_sharded"))
def _bucket_step(F, len_mask, scale_factors, ds_start, nmf_cfg: NMFConfig,
                 eng_cfg: EngineConfig,
                 with_estimates: bool = True,
                 mesh=None, mesh_axis: str = "genes",
                 column_sharded: bool = False) -> BucketResult:
    """One DegNorm iteration's device work for one bucket: scale-adjust the
    coverage (nmf.py:142-146,563) then run batched baseline selection.
    ``with_estimates=False`` skips the (G, W) estimate factor output —
    intermediate iterations only need DI scores.

    ``F`` may arrive as int16 (integral coverage uploads at half the
    bytes); it is cast to the compute dtype on device.

    With ``mesh`` (gene-sharded bucket), the whole computation — which is
    per-gene end to end — runs under shard_map so the GPU kernel sees
    local shard shapes."""
    eng_cfg = _seqpar_safe(eng_cfg, column_sharded)

    def step(F, len_mask, ds_start, scale_factors):
        Ff = F.astype(scale_factors.dtype)
        F_adj = Ff / scale_factors[None, :, None]
        return baseline_select_bucket(
            F_adj, len_mask, nmf_cfg, eng_cfg,
            ds_start=ds_start,
            with_estimates=with_estimates)

    if mesh is not None and mesh.devices.size > 1:
        return _shard_map_genes(step, mesh, mesh_axis,
                                (F, len_mask, ds_start), (scale_factors,))
    return step(F, len_mask, ds_start, scale_factors)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _permute_on_device(F, len_mask, idx, perm):
    """Gene-axis gather of a bucket's device buffers in ONE jitted dispatch
    (async, with the old buffers donated: no transient 2x device memory).
    ``idx`` is the device-resident gene_indices cache (kept on device so
    the per-iteration scatter calls don't re-upload it)."""
    return (jnp.take(F, perm, axis=0), jnp.take(len_mask, perm, axis=0),
            jnp.take(idx, perm, axis=0))


@functools.partial(jax.jit, static_argnames=("n",))
def _device_scatter(parts, idx_parts, n, fill):
    """Scatter per-bucket per-gene rows into a global (n, ...) array on
    device (padding slots land in a dropped n-th row)."""
    shape = (n + 1,) + parts[0].shape[1:]
    out = jnp.full(shape, fill, parts[0].dtype)
    for part, idx in zip(parts, idx_parts):
        safe = jnp.where(idx >= 0, idx, n)
        out = out.at[safe].set(part)
    return out[:n]


@functools.partial(jax.jit, static_argnames=("n",))
def _init_sums(cov_parts, est_parts, idx_parts, n):
    """Scatter every bucket's ratio-SVD row sums into global (n, p) arrays
    ON DEVICE and return them stacked: the host loop then pays ONE device
    fetch for initialization instead of two per bucket."""
    cov = _device_scatter(cov_parts, idx_parts, n, 0.0)
    est = _device_scatter(est_parts, idx_parts, n, 0.0)
    return jnp.stack([cov, est])


@functools.partial(jax.jit, static_argnames=("n",))
def _iter_outputs(rho_parts, ran_parts, rounds_parts, idx_parts, n):
    """Per-iteration twin of _init_sums for the host loop: scatter every
    bucket's DI rows, ran-baseline-selection flags AND trim-round counts
    into one (n, p+2) array on device so the host fetches once per
    iteration.  Values are identical to the per-bucket host scatter (f32
    rho verbatim; the bool flag and int32 rounds ride as floats in the
    two extra columns — rounds <= 16 are exact).  Folding rounds_active
    in here lets the exit-round reorder run without per-bucket fetches."""
    rho = _device_scatter(rho_parts, idx_parts, n, 0.0)
    ran = _device_scatter(
        tuple(r.astype(rho.dtype) for r in ran_parts), idx_parts, n, 0.0)
    rounds = _device_scatter(
        tuple(r.astype(rho.dtype) for r in rounds_parts), idx_parts, n, 0.0)
    return jnp.concatenate([rho, ran[:, None], rounds[:, None]], axis=1)


@functools.partial(jax.jit, static_argnames=("n",))
def _device_iteration_update(rho_parts, idx_parts, x_weighted,
                             scale_factors, n):
    """Device-resident twin of core.degnorm.iteration_update — used when the
    mesh spans multiple processes and per-bucket results cannot be
    materialized on any single host.  Cross-gene column sums become psums
    over the gene shards; all outputs are (n, p)/(p,)-sized and replicated.
    """
    rho_raw = _device_scatter(rho_parts, idx_parts, n, 0.0)
    return outer.device_iteration_math(rho_raw, x_weighted, scale_factors)


@functools.partial(jax.jit, static_argnames=("n",))
def _device_init_state(cov_parts, est_parts, idx_parts, x, n):
    """Device-resident twin of init_state + rho_from_ratio_svd
    (nmf.py:512-535).  Also returns the initial rho so the single-process
    device loop can run the same init-DI presort as the host loop (the
    fetch is skipped when unused)."""
    cov_sums = _device_scatter(cov_parts, idx_parts, n, 0.0)
    est_sums = _device_scatter(est_parts, idx_parts, n, 0.0)
    rho = 1 - cov_sums / (est_sums + 1)
    low_di = jnp.max(rho, axis=1) < 0.1
    any_low = jnp.any(low_di)
    count_sums = jnp.where(
        any_low, jnp.sum(x * low_di[:, None], axis=0), jnp.sum(x, axis=0))
    norm = count_sums / jnp.median(count_sums)
    return x / norm, norm, rho


@jax.jit
def _flat_concat(parts):
    """Flatten + concatenate device arrays into ONE vector (dtype of the
    first part) so the host pays a single device fetch instead of one per
    array (the final-state fetch of the device loop would otherwise be
    10+ separate transfers)."""
    dt = parts[0].dtype
    return jnp.concatenate([jnp.ravel(p).astype(dt) for p in parts])


@functools.partial(jax.jit, static_argnames=("n",))
def _device_init_state_df(cov_parts, est_parts, idx_parts, x_df, n):
    """Double-float twin of _device_init_state (core.degnorm.df_init_math):
    outer init at ~f64 accuracy in f32 arithmetic.  Returns (xw DF, norm
    DF, scale32, rho_proxy): scale32 is the f32 rounding of the initial
    scale factors (= norm) for the bucket kernels, rho_proxy the (n,)
    per-gene max initial DI — the presort key — so the host fetch is an
    8x smaller vector instead of the (n, p) rho matrix."""
    from degnorm_jax.core import dfloat as dfm
    cov_sums = _device_scatter(cov_parts, idx_parts, n, 0.0)
    est_sums = _device_scatter(est_parts, idx_parts, n, 0.0)
    xw, norm, rho32 = outer.df_init_math(cov_sums, est_sums, x_df)
    return xw, norm, dfm.to_f32(norm), jnp.max(rho32, axis=1)


@functools.partial(jax.jit, static_argnames=("n",))
def _device_iteration_update_df(rho_parts, idx_parts, xw_df, scale_df, n):
    """Double-float twin of _device_iteration_update: the same op order as
    the f64 host loop's iteration_update, in two-f32 compensated
    arithmetic (core/dfloat.py).  Also returns the f32 rounding of the new
    scale factors for the next iteration's bucket kernels, computed in-jit
    so the host never issues an eager df→f32 add."""
    from degnorm_jax.core import dfloat as dfm
    rho_raw = _device_scatter(rho_parts, idx_parts, n, 0.0)
    rho, x_adj, xw_new, norm, scale_new = outer.df_iteration_math(
        rho_raw, xw_df, scale_df)
    return rho, x_adj, xw_new, norm, scale_new, dfm.to_f32(scale_new)


@functools.partial(jax.jit, static_argnames=("eng_cfg", "mesh", "mesh_axis",
                                             "column_sharded"))
def _bucket_init(F, len_mask, eng_cfg: EngineConfig,
                 mesh=None, mesh_axis: str = "genes",
                 column_sharded: bool = False):
    """Initialization: ratio-SVD row sums on the raw coverage
    (nmf.py:522-526).  Per-gene end to end, so it shard_maps like
    _bucket_step when the bucket is mesh-sharded."""
    eng_cfg = _seqpar_safe(eng_cfg, column_sharded)

    def init(F, len_mask):
        if F.dtype == jnp.int16:
            F = F.astype(jnp.dtype(eng_cfg.dtype))
        return ratio_svd_rowsums(F, len_mask,
                                 power_iters=eng_cfg.power_iters_cold,
                                 method=eng_cfg.rank1_method)

    if mesh is not None and mesh.devices.size > 1:
        return _shard_map_genes(init, mesh, mesh_axis, (F, len_mask), ())
    return init(F, len_mask)


def _device_memory_bytes() -> int:
    """Smallest device-memory limit over the local devices (the bucket
    size cap must fit every card a bucket can land on).  Multi-process
    runs use a fixed 16 GiB so that every process picks identical bucket
    shapes; so does a backend that reports no memory stats (CPU)."""
    default = 16 << 30
    if jax.process_count() > 1:
        return default
    limits = [int((d.memory_stats() or {}).get("bytes_limit", 0))
              for d in jax.local_devices()]
    limits = [b for b in limits if b > 0]
    return min(limits) if limits else default


class DegNormResult:
    """Fit outputs; attribute names follow the reference's GeneNMFOA state."""

    def __init__(self, genes, rho, x_adj, scale_factors, norm_factors,
                 ran_baseline_selection, x_weighted, engine):
        self.genes = genes
        self.rho = rho
        self.x_adj = x_adj
        self.scale_factors = scale_factors
        self.norm_factors = norm_factors
        self.ran_baseline_selection = ran_baseline_selection
        self.x_weighted = x_weighted
        self._engine = engine

    def estimates(self) -> List[np.ndarray]:
        """Materialize per-gene estimated coverage matrices (p x L_i), in
        input gene order — the reference's ``run()`` return value."""
        return self._engine._materialize_estimates()


def default_cache_dir() -> str:
    """The persistent compile cache's directory: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads that variable itself), else ``<checkout>/.jax_cache``
    (listed in .gitignore).  A fixed path, because the cache key includes
    it: a directory that moves never hits."""
    import os
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at default_cache_dir(),
    unless JAX_COMPILATION_CACHE_DIR already configured it.  GPU only:
    XLA:CPU cache entries embed machine features, and CPU compiles (the
    test platform) are fast anyway."""
    from degnorm_jax.ops.nmf_gpu import on_gpu
    if not on_gpu():
        return
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", default_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


class DegNormEngine:
    def __init__(self, nmf_cfg: Optional[NMFConfig] = None,
                 eng_cfg: Optional[EngineConfig] = None,
                 mesh=None):
        """``mesh``: optional 1-D jax.sharding.Mesh; when given, every
        bucket's gene axis is sharded across its devices (the NMF/trim
        kernels are gene-parallel, so no collectives are needed —
        parallel/sharded.py)."""
        enable_compile_cache()
        self.nmf_cfg = nmf_cfg or NMFConfig()
        self.eng_cfg = eng_cfg or EngineConfig()
        self.mesh = mesh
        self._buckets: List[GeneBucket] = []
        self._device_F: List[jnp.ndarray] = []
        self._device_mask: List[jnp.ndarray] = []
        self._last_results: List[BucketResult] = []
        self._final_scale: Optional[np.ndarray] = None

    # -- setup -----------------------------------------------------------
    def _pack(self, cov_mats: Sequence[np.ndarray]):
        dtype = jnp.dtype(self.eng_cfg.dtype)
        n_devices = int(self.mesh.devices.size) if self.mesh is not None else 1
        # Device-memory guard: one bucket's f32 form plus several iteration
        # transients (cast, scale-adjust — and on the XLA fallback path the
        # trim loop's per-round arrays) must coexist with the resident
        # compressed pool, so cap each padded bucket at ~1/8 of HBM
        # (scaled by mesh size — the gene axis shards).
        hbm = _device_memory_bytes()
        import time as _time
        t0 = _time.perf_counter()
        # Integral small-valued coverage (the common case — read pileups)
        # packs straight into int16: half the float32 page-fault/copy cost
        # and the delta encoder skips its validation passes.
        from degnorm_jax.data.buckets import integral_int16able
        pack_dtype = (np.int16
                      if dtype == jnp.float32 and integral_int16able(cov_mats)
                      else np.dtype(dtype.name))
        self.timings["pack_scan"] = _time.perf_counter() - t0
        self._device_idx = None    # invalidate (rebuilt lazily per bucket set)
        t0 = _time.perf_counter()
        self._buckets = pack_buckets(
            cov_mats,
            bucket_widths=self.eng_cfg.bucket_widths,
            dtype=pack_dtype,
            pad_genes_to=n_devices,
            max_genes_per_bucket=self.eng_cfg.max_genes_per_batch,
            max_bucket_bytes=max(hbm // 8, 512 << 20) * max(n_devices, 1),
            budget_itemsize=dtype.itemsize,
        )
        self.timings["pack_host"] = _time.perf_counter() - t0
        def upload_form(F):
            # integral coverage bounded by int16 uploads at half the bytes
            # (host->device links are often the cold-start bottleneck);
            # kernels cast back to the compute dtype on device.
            from degnorm_jax.data.encode import int16able
            if F.dtype == np.int16:
                return F
            if dtype == jnp.float32 and int16able(F):
                return F.astype(np.int16)
            return F

        if self.mesh is not None:
            from degnorm_jax.parallel.sharded import shard_bucket
            from degnorm_jax.parallel.seqpar import shard_columns
            placed = []
            self._bucket_gene_sharded = []
            for b in self._buckets:
                if b.width >= self.eng_cfg.seqpar_width:
                    # sequence-parallel: outlier-length genes shard the
                    # position axis instead of the (few) genes
                    placed.append((
                        shard_columns(jnp.asarray(upload_form(b.F)),
                                      self.mesh, self.eng_cfg.mesh_axis),
                        shard_columns(jnp.asarray(b.len_mask()),
                                      self.mesh, self.eng_cfg.mesh_axis)))
                    self._bucket_gene_sharded.append(False)
                else:
                    placed.append(shard_bucket(upload_form(b.F),
                                               b.len_mask(), self.mesh))
                    self._bucket_gene_sharded.append(True)
            self._device_F = [f for f, _ in placed]
            self._device_mask = [m for _, m in placed]
        else:
            from degnorm_jax.data.encode import (decode_coverage_device,
                                                 encode_coverage)
            t0 = _time.perf_counter()
            self._device_F = []
            for b in self._buckets:
                # delta upload (int4 for int16 buckets — ~1/8 of float32
                # bytes; int8 otherwise), exact int16 reconstruction in one
                # device pass
                enc = (encode_coverage(b.F, n_real=b.n_real)
                       if dtype == jnp.float32 else None)
                self._device_F.append(
                    decode_coverage_device(enc) if enc is not None
                    else jnp.asarray(upload_form(b.F)))
            self._device_mask = [jnp.asarray(b.len_mask())
                                 for b in self._buckets]
            self._bucket_gene_sharded = [False] * len(self._buckets)
            self.timings["encode_upload"] = _time.perf_counter() - t0

    def _device_idx_parts(self):
        """Device-resident gene_indices per bucket, built lazily and kept
        in sync by _permute_bucket, so the per-iteration _iter_outputs /
        _init_sums calls pay no host->device copy per bucket."""
        if jax.process_count() > 1:
            # multi-process: keep host numpy (lifted as replicated data by
            # the global-mesh jit; a process-local committed jax.Array
            # could not be resharded).  Permutes are disabled on meshes,
            # so no cache coherence is needed either.
            return tuple(np.asarray(b.gene_indices, np.int32)
                         for b in self._buckets)
        cache = getattr(self, "_device_idx", None)
        if cache is None or len(cache) != len(self._buckets):
            cache = [jnp.asarray(np.asarray(b.gene_indices, np.int32))
                     for b in self._buckets]
            self._device_idx = cache
        return tuple(cache)

    def _bucket_mesh(self, i: int):
        """Mesh for bucket i's kernels: only gene-sharded buckets shard_map
        (column-sharded seqpar buckets keep the GSPMD lowering)."""
        if self.mesh is None or not getattr(self, "_bucket_gene_sharded",
                                            None):
            return None
        return self.mesh if self._bucket_gene_sharded[i] else None

    def _col_sharded(self, i: int) -> bool:
        """True for seqpar (column-sharded) buckets — their kernels must
        stay on the GSPMD-partitionable XLA path (see _seqpar_safe)."""
        return (self.mesh is not None
                and bool(getattr(self, "_bucket_gene_sharded", None))
                and not self._bucket_gene_sharded[i])

    def _ds_starts(self, bucket: GeneBucket, iteration: int) -> jnp.ndarray:
        """Deterministic per-gene systematic-sampling offsets.

        The reference draws thread-shared numpy randints (racy under
        threading, SURVEY.md §2.2); we key a PRNG per (seed, iteration,
        gene) instead — a documented behavioral fix.  Offsets are drawn
        for the GLOBAL gene order and looked up by gene id, so they are
        invariant to bucket-internal permutations (init presort,
        exit-round reorder) and to resume/mesh paths — the property
        PARITY.md documents."""
        if self.nmf_cfg.downsample_rate <= 1:
            G = bucket.F.shape[0]
            if jax.process_count() > 1:
                # multi-process: a process-local committed jax.Array
                # cannot be resharded into the global-mesh jit; host numpy
                # is lifted as replicated data safely
                return np.zeros(G, np.int32)
            # cached device-resident zeros per bucket size: without this,
            # every iteration re-uploads a fresh numpy zeros vector per
            # bucket (see _device_idx_parts)
            cache = getattr(self, "_ds_zero_cache", None)
            if cache is None:
                cache = {}
                self._ds_zero_cache = cache
            if G not in cache:
                cache[G] = jnp.zeros((G,), jnp.int32)
            return cache[G]
        if self.nmf_cfg.ds_compat == "reference":
            # Reproduce the reference's exact offset stream (nmf.py:422,
            # 556 at n_jobs=1): np.random.seed(123), then ONE scalar
            # np.random.choice(rate) per gene per iteration, genes in
            # input-dict order.  Drawn lazily iteration-by-iteration so
            # checkpoint resume at iteration k consumes k prior vectors.
            draws = getattr(self, "_ds_ref_draws", None)
            if draws is None:
                draws = []
                self._ds_ref_draws = draws
                self._ds_ref_rs = np.random.RandomState(
                    self.nmf_cfg.random_state)
            while len(draws) <= iteration:
                rs = self._ds_ref_rs
                draws.append(np.array(
                    [rs.choice(self.nmf_cfg.downsample_rate)
                     for _ in range(self._n_genes)], np.int32))
            return draws[iteration][np.maximum(bucket.gene_indices, 0)]
        # draw the global vector once per iteration (one eager PRNG call
        # instead of one per bucket)
        cache = getattr(self, "_ds_cache", None)
        if cache is None or cache[0] != iteration:
            key = jax.random.fold_in(
                jax.random.PRNGKey(self.nmf_cfg.random_state), iteration)
            cache = (iteration, np.asarray(jax.random.randint(
                key, (self._n_genes,), 0, self.nmf_cfg.downsample_rate,
                dtype=jnp.int32)))
            self._ds_cache = cache
        return cache[1][np.maximum(bucket.gene_indices, 0)]

    # -- main loop -------------------------------------------------------
    def run(self, cov_dat: Mapping[str, np.ndarray],
            reads_dat: np.ndarray,
            checkpoint_dir: Optional[str] = None,
            reuse_device_data: bool = False) -> DegNormResult:
        """Fit DegNorm.  With ``checkpoint_dir``, outer-loop state is
        snapshotted after every iteration and a matching checkpoint found
        there resumes the loop mid-run (the reference has no in-loop
        checkpointing, SURVEY.md §5.4).

        ``reuse_device_data``: opt-in refit on the previous ``run``'s
        device-resident buckets — the packer and host->device upload are
        skipped entirely.  The CALLER asserts the coverage CONTENTS are
        unchanged; a cheap content-derived fingerprint (gene count, total
        width, first/last matrix shapes and edge-column sums) guards
        against accidentally passing a different dataset, but changed
        values inside the same arrays are not fully detected.  Gene order inside buckets may differ from a fresh
        pack (the previous run's presort persists), which is
        result-invariant (results scatter through gene_indices).  Used by
        steady-state benchmarking and repeated fits over one dataset.

        Every device path is chosen up front (ops/nmf_gpu.py::
        kernel_enabled and kernel_supported); a kernel that fails to
        compile fails the fit."""
        return self._run(cov_dat, reads_dat, checkpoint_dir,
                         reuse_device_data=reuse_device_data)

    def _run(self, cov_dat: Mapping[str, np.ndarray],
             reads_dat: np.ndarray,
             checkpoint_dir: Optional[str] = None,
             reuse_device_data: bool = False) -> DegNormResult:
        import time as _time
        genes = list(cov_dat.keys())
        cov_mats = [np.asarray(cov_dat[g]) for g in genes]
        n = len(cov_mats)
        self._n_genes = n
        if n == 0:
            raise ValueError("no coverage matrices supplied")
        if self.nmf_cfg.degnorm_iter < 1:
            raise ValueError("degnorm_iter must be >= 1")
        p = cov_mats[0].shape[0]
        x = np.asarray(reads_dat, dtype=np.float64)
        if x.shape[0] != n:
            raise ValueError(
                "read count matrix rows != number of coverage matrices")
        if any(F.ndim != 2 for F in cov_mats):
            raise ValueError("all coverage matrices must be 2-d")
        if self.nmf_cfg.downsample_rate > 1:
            if min(F.shape[1] for F in cov_mats) < self.nmf_cfg.downsample_rate:
                raise ValueError(
                    "downsample_rate exceeds the shortest gene length")

        t0 = _time.perf_counter()
        self.timings = {}
        # fresh downsample-offset stream per fit (the reference re-seeds
        # np.random.seed(123) inside every run(), nmf.py:556)
        self._ds_ref_draws = None
        self._ds_cache = None
        fingerprint = _data_fingerprint(cov_mats, n)
        reuse = (reuse_device_data and self._buckets
                 and getattr(self, "_packed_fp", None) == fingerprint
                 and len(self._device_F) == len(self._buckets))
        if not reuse:
            self._pack(cov_mats)
            self._packed_fp = fingerprint
        dtype = jnp.dtype(self.eng_cfg.dtype)
        self.timings["pack"] = _time.perf_counter() - t0

        # Default (None): the device-resident outer loop — fastest measured
        # configuration (zero per-iteration host syncs) and, since round
        # 4's double-float updates (outer_df), also f64-grade.  Mandatory
        # when the mesh spans processes (per-bucket results are not
        # host-materializable).  device_loop=False opts back into the
        # host float64 loop (the original parity reference).
        device_loop = (self.eng_cfg.device_loop
                       if self.eng_cfg.device_loop is not None
                       else True)
        if not device_loop and self.mesh is not None \
                and jax.process_count() > 1:
            device_loop = True
        if device_loop:
            return self._run_device_loop(genes, cov_mats, x, n, p, dtype,
                                         checkpoint_dir=checkpoint_dir)

        # ---- resume from checkpoint? ----
        start_iter = 0
        state = None
        ran_bs = np.zeros((n, self.nmf_cfg.degnorm_iter), dtype=bool)
        if checkpoint_dir:
            from degnorm_jax.pipeline.checkpoints import load_checkpoint
            ckpt = load_checkpoint(checkpoint_dir, genes)
            if ckpt and ckpt["iteration"] + 1 < self.nmf_cfg.degnorm_iter:
                state = ckpt["state"]
                saved = ckpt["ran_baseline_selection"]
                ran_bs[:, :saved.shape[1]] = saved[:, :ran_bs.shape[1]]
                start_iter = ckpt["iteration"] + 1

        # ---- initialization (nmf.py:512-535) ----
        if state is None:
            t0 = _time.perf_counter()
            init_out = [_bucket_init(F_d, m_d, self.eng_cfg,
                                     mesh=self._bucket_mesh(i),
                                     mesh_axis=self.eng_cfg.mesh_axis,
                                     column_sharded=self._col_sharded(i))
                        for i, (F_d, m_d) in enumerate(
                            zip(self._device_F, self._device_mask))]
            self.timings["init_dispatch"] = _time.perf_counter() - t0
            idx_parts = self._device_idx_parts()
            t1 = _time.perf_counter()
            sums = np.asarray(_init_sums(
                tuple(cs for cs, _ in init_out),
                tuple(es for _, es in init_out),
                idx_parts, n), np.float64)
            self.timings["init_fetch"] = _time.perf_counter() - t1
            cov_sums, est_sums = sums[0], sums[1]
            rho_init = outer.rho_from_ratio_svd(cov_sums, est_sums)
            state = outer.init_state(rho_init, x)
            t1 = _time.perf_counter()
            self._presort_by_init_rho(rho_init)
            self.timings["init_presort"] = _time.perf_counter() - t1
            self.timings["init"] = _time.perf_counter() - t0

        # ---- DegNorm iterations (nmf.py:556-596) ----
        import contextlib
        prof = (jax.profiler.trace(self.eng_cfg.profile_dir)
                if self.eng_cfg.profile_dir else contextlib.nullcontext())
        t0 = _time.perf_counter()
        with prof:
            for it in range(start_iter, self.nmf_cfg.degnorm_iter):
                t_it = _time.perf_counter()
                sf = jnp.asarray(state.scale_factors, dtype)
                # dispatch every bucket first (async), then materialize —
                # device execution and host transfers pipeline across
                # buckets instead of round-tripping one at a time
                # per-bucket dispatches (all async before any sync): each
                # bucket kernel caches independently and is reusable across
                # datasets, unlike a fused whole-profile program
                final = it == self.nmf_cfg.degnorm_iter - 1
                results: List[BucketResult] = [
                    _bucket_step(F_d, m_d, sf, self._ds_starts(b, it),
                                 self.nmf_cfg.kernel_key(), self.eng_cfg,
                                 with_estimates=final,
                                 mesh=self._bucket_mesh(i),
                                 mesh_axis=self.eng_cfg.mesh_axis,
                                 column_sharded=self._col_sharded(i))
                    for i, (b, F_d, m_d) in enumerate(
                        zip(self._buckets, self._device_F,
                            self._device_mask))]
                # ONE device-side scatter + host fetch for all buckets'
                # (rho, ran_bs, rounds) instead of one transfer per array
                # (see _init_sums).
                out = np.asarray(_iter_outputs(
                    tuple(res.rho for res in results),
                    tuple(res.ran_bs for res in results),
                    tuple(res.rounds_active for res in results),
                    self._device_idx_parts(), n))
                rho_raw = out[:, :p].astype(np.float64)
                ran_bs[:, it] = out[:, p] > 0.5
                state = outer.iteration_update(state, rho_raw)
                if (it == start_iter
                        and it + 1 < self.nmf_cfg.degnorm_iter):
                    self._reorder_by_exit_round(out[:, p + 1])
                self.timings[f"iter_{it}"] = _time.perf_counter() - t_it
                if checkpoint_dir:
                    from degnorm_jax.pipeline.checkpoints import (
                        save_checkpoint)
                    save_checkpoint(checkpoint_dir, it, state,
                                    ran_bs[:, :it + 1], genes)
        self.timings["iterations"] = _time.perf_counter() - t0

        self._last_results = results
        self._final_scale = state.scale_factors / state.norm_factors
        self._genes = genes
        self._cov_mats = cov_mats

        return DegNormResult(
            genes=genes, rho=state.rho, x_adj=state.x_adj,
            scale_factors=state.scale_factors,
            norm_factors=state.norm_factors,
            ran_baseline_selection=ran_bs, x_weighted=state.x_weighted,
            engine=self)

    # -- device-resident outer loop (multi-process / opt-in) -------------
    def _gather(self, arr) -> np.ndarray:
        """Materialize a device array on every process (allgather when the
        mesh spans processes; plain transfer otherwise)."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return np.asarray(
                multihost_utils.process_allgather(arr, tiled=True))
        return np.asarray(arr)

    def _gather_f64(self, v) -> np.ndarray:
        """Materialize a device quantity as float64 on every process:
        double-float pairs recombine hi + lo in f64 (recovering ~f64
        accuracy); plain arrays upcast."""
        from degnorm_jax.core import dfloat as dfm
        if isinstance(v, dfm.DF):
            return dfm.to_f64_np(self._gather(v.hi), self._gather(v.lo))
        return self._gather(v).astype(np.float64)

    def _save_device_checkpoint(self, checkpoint_dir: str, it: int, x,
                                rho, x_adj, x_weighted, norm, scale,
                                ran_restored: np.ndarray, ran_cols,
                                genes) -> None:
        """Gather the device loop's state and snapshot it in the host
        loop's checkpoint format.  The gathers are collectives on a
        multi-process mesh — EVERY process must call this; the file write
        itself is coordinator-gated inside save_checkpoint."""
        from degnorm_jax.core.degnorm import GlobalState
        from degnorm_jax.pipeline.checkpoints import save_checkpoint
        state = GlobalState(
            x=np.asarray(x, np.float64),
            x_weighted=self._gather_f64(x_weighted),
            x_adj=self._gather_f64(x_adj),
            rho=self._gather_f64(rho),
            norm_factors=self._gather_f64(norm),
            scale_factors=self._gather_f64(scale))
        ran = np.concatenate(
            [ran_restored]
            + [np.asarray(self._gather(c), bool)[:, None] for c in ran_cols],
            axis=1)
        save_checkpoint(checkpoint_dir, it, state, ran, genes)

    def _run_device_loop(self, genes, cov_mats, x, n, p, dtype,
                         checkpoint_dir: Optional[str] = None
                         ) -> DegNormResult:
        """Outer loop with all global updates on device (jnp twins of
        core/degnorm.py).  Required when the gene mesh spans multiple
        processes: per-bucket results are sharded across hosts and cannot
        be materialized locally.  Cross-gene column sums become psums over
        the gene shards; only the final (n, p) matrices are gathered.

        Per-iteration checkpoints gather the loop state to numpy (an
        allgather collective every process participates in; the write is
        coordinator-gated), so the file format matches the host loop's and
        either loop can resume the other's run.

        Outer-update precision: with ``EngineConfig.outer_df`` (default)
        the global updates run in two-f32 compensated arithmetic
        (core/dfloat.py, ~f64 accuracy), closing the round-3 precision gap
        (plain-f32 updates drifted adjusted counts up to 4e-2 through
        borderline-trim feedback).  ``outer_df=False`` keeps the plain
        engine-dtype updates."""
        import time as _time
        from degnorm_jax.core import dfloat as dfm
        # df only pays off when the device dtype is f32; float64 engine
        # runs (CPU parity mode) already match the host loop exactly with
        # plain updates.
        use_df = self.eng_cfg.outer_df and dtype == jnp.float32
        # shares the host loop's device-resident cache (multi-process:
        # host numpy, replicated by jit) — the presort/reorder below would
        # otherwise re-upload identical arrays through the cache
        idx_parts = self._device_idx_parts()
        if use_df:
            x_df = dfm.DF(*map(jnp.asarray, dfm.from_f64_np(x)))
        else:
            x_d = jnp.asarray(x, dtype)

        # ---- resume from checkpoint? (mirrors the host loop) ----
        start_iter = 0
        ran_restored = np.zeros((n, 0), dtype=bool)
        ckpt = None
        if checkpoint_dir:
            from degnorm_jax.pipeline.checkpoints import load_checkpoint
            ckpt = load_checkpoint(checkpoint_dir, genes)
            if ckpt and ckpt["iteration"] + 1 < self.nmf_cfg.degnorm_iter:
                start_iter = ckpt["iteration"] + 1
                ran_restored = np.asarray(
                    ckpt["ran_baseline_selection"][:, :start_iter], bool)
            else:
                ckpt = None

        t0 = _time.perf_counter()
        if ckpt is not None:
            # all processes load the same shared file, so these host-local
            # arrays are identical everywhere (same replication contract
            # as the count upload above)
            st = ckpt["state"]
            if use_df:
                x_weighted = dfm.DF(*map(
                    jnp.asarray, dfm.from_f64_np(st.x_weighted)))
                norm = dfm.DF(*map(
                    jnp.asarray, dfm.from_f64_np(st.norm_factors)))
                scale = dfm.DF(*map(
                    jnp.asarray, dfm.from_f64_np(st.scale_factors)))
                # correctly-rounded f64 -> f32 on host (no eager device op)
                scale32 = jnp.asarray(
                    st.scale_factors.astype(np.float32))
            else:
                x_weighted = jnp.asarray(st.x_weighted, dtype)
                norm = jnp.asarray(st.norm_factors, dtype)
                scale = jnp.asarray(st.scale_factors, dtype)
                scale32 = scale
        else:
            init_out = [_bucket_init(F_d, m_d, self.eng_cfg,
                                     mesh=self._bucket_mesh(i),
                                     mesh_axis=self.eng_cfg.mesh_axis,
                                     column_sharded=self._col_sharded(i))
                        for i, (F_d, m_d) in enumerate(
                            zip(self._device_F, self._device_mask))]
            if use_df:
                x_weighted, norm, scale32, rho_proxy_d = \
                    _device_init_state_df(
                        tuple(cs.astype(jnp.float32) for cs, _ in init_out),
                        tuple(es.astype(jnp.float32) for _, es in init_out),
                        idx_parts, x_df, n)
            else:
                x_weighted, norm, rho_init_d = _device_init_state(
                    tuple(cs.astype(dtype) for cs, _ in init_out),
                    tuple(es.astype(dtype) for _, es in init_out),
                    idx_parts, x_d, n)
                scale32 = norm
                rho_proxy_d = jnp.max(rho_init_d, axis=1)
            scale = norm
            self.timings["init_dispatch"] = _time.perf_counter() - t0
            if self.mesh is None:
                # same init-DI presort as the host loop (single-process
                # only — on a multi-process mesh the permutation guards in
                # _presort/_reorder apply).  The fetch is the (n,) per-gene
                # max-DI proxy (8x fewer bytes than the full rho matrix).
                # Its blocking time (init_fetch) absorbs upload completion,
                # ratio-SVD compute and any compile cost.
                t1 = _time.perf_counter()
                proxy = np.asarray(rho_proxy_d)
                self.timings["init_fetch"] = _time.perf_counter() - t1
                self._presort_by_init_rho(proxy)
                idx_parts = self._device_idx_parts()
        self.timings["init"] = _time.perf_counter() - t0

        ran_cols = []
        rho = x_adj = None
        import contextlib
        prof = (jax.profiler.trace(self.eng_cfg.profile_dir)
                if self.eng_cfg.profile_dir else contextlib.nullcontext())
        t0 = _time.perf_counter()
        with prof:
            for it in range(start_iter, self.nmf_cfg.degnorm_iter):
                t_it = _time.perf_counter()
                final = it == self.nmf_cfg.degnorm_iter - 1
                results = [
                    _bucket_step(F_d, m_d, scale32.astype(dtype),
                                 self._ds_starts(b, it),
                                 self.nmf_cfg.kernel_key(), self.eng_cfg,
                                 with_estimates=final,
                                 mesh=self._bucket_mesh(i),
                                 mesh_axis=self.eng_cfg.mesh_axis,
                                 column_sharded=self._col_sharded(i))
                    for i, (b, F_d, m_d) in enumerate(
                        zip(self._buckets, self._device_F,
                            self._device_mask))]
                if use_df:
                    (rho, x_adj, x_weighted, norm, scale,
                     scale32) = _device_iteration_update_df(
                        tuple(r.rho for r in results), idx_parts,
                        x_weighted, scale, n)
                else:
                    rho, x_adj, x_weighted, norm, scale = \
                        _device_iteration_update(
                            tuple(r.rho for r in results), idx_parts,
                            x_weighted, scale, n)
                    scale32 = scale
                ran_cols.append(_device_scatter(
                    tuple(r.ran_bs for r in results), idx_parts, n, False))
                if (self.mesh is None and it == start_iter
                        and it + 1 < self.nmf_cfg.degnorm_iter):
                    # same exit-round reorder as the host loop (one fetch,
                    # once per run — does not break the loop's
                    # per-iteration no-sync property)
                    rounds = np.asarray(_device_scatter(
                        tuple(r.rounds_active for r in results), idx_parts,
                        n, 0))
                    self._reorder_by_exit_round(rounds)
                    idx_parts = self._device_idx_parts()
                self.timings[f"iter_{it}"] = _time.perf_counter() - t_it
                if checkpoint_dir:
                    self._save_device_checkpoint(
                        checkpoint_dir, it, x, rho, x_adj, x_weighted,
                        norm, scale, ran_restored, ran_cols, genes)
        self.timings["iterations"] = _time.perf_counter() - t0

        self._last_results = results
        self._genes = genes
        self._cov_mats = cov_mats

        if jax.process_count() == 1:
            # single fetch for the whole final state: every quantity
            # (df pairs flattened) rides one concatenated vector instead
            # of one transfer each
            from degnorm_jax.core import dfloat as dfm
            pieces = []
            for v in (rho, x_adj, x_weighted, norm, scale):
                pieces.extend([v.hi, v.lo] if isinstance(v, dfm.DF)
                              else [v])
            pieces.extend(ran_cols)
            flat = np.asarray(_flat_concat(tuple(pieces)), np.float64)
            outs, off = [], 0
            for v, sh in ((rho, (n, p)), (x_adj, (n, p)),
                          (x_weighted, (n, p)), (norm, (p,)),
                          (scale, (p,))):
                sz = int(np.prod(sh))
                if isinstance(v, dfm.DF):
                    hi = flat[off:off + sz].reshape(sh)
                    lo = flat[off + sz:off + 2 * sz].reshape(sh)
                    off += 2 * sz
                    outs.append(hi + lo)
                else:
                    outs.append(flat[off:off + sz].reshape(sh))
                    off += sz
            rho64, xadj64, xw64, norm64, scale64 = outs
            ran_np = [flat[off + i * n: off + (i + 1) * n] > 0.5
                      for i in range(len(ran_cols))]
        else:
            rho64 = self._gather_f64(rho)
            xadj64 = self._gather_f64(x_adj)
            xw64 = self._gather_f64(x_weighted)
            norm64 = self._gather_f64(norm)
            scale64 = self._gather_f64(scale)
            ran_np = [np.asarray(self._gather(c), bool) for c in ran_cols]
        self._final_scale = scale64 / norm64

        ran_bs = np.concatenate(
            [ran_restored] + [c[:, None] for c in ran_np], axis=1)
        return DegNormResult(
            genes=genes,
            rho=rho64,
            x_adj=xadj64,
            scale_factors=scale64,
            norm_factors=norm64,
            ran_baseline_selection=ran_bs,
            x_weighted=xw64,
            engine=self)

    def _permute_bucket(self, i: int, perm: np.ndarray) -> None:
        """Reorder bucket i's genes on device + its host metadata.  Gene
        order within a bucket is internal (results scatter back through
        gene_indices; the kernels are per-gene), so permutations are exact
        and change only the order in which genes reach the device.  b.F is
        NOT permuted: after upload it is only read for its shape (copying
        the multi-hundred-MB host array costs seconds and nothing consumes
        its contents again)."""
        b = self._buckets[i]
        pj = jnp.asarray(perm.astype(np.int32))
        idx_cache = self._device_idx_parts()[i]
        (self._device_F[i], self._device_mask[i],
         self._device_idx[i]) = _permute_on_device(
            self._device_F[i], self._device_mask[i], idx_cache, pj)
        b.lengths = b.lengths[perm]
        b.gene_indices = b.gene_indices[perm]

    def _presort_by_init_rho(self, rho_init: np.ndarray) -> None:
        """Before iteration 0, sort each bucket's genes by their ratio-SVD
        DI proxy: genes whose initial max-DI is small tend to leave the
        trim loop immediately, so sorting ascending makes the likely-active
        set a contiguous suffix already in the first iteration.
        Skipped for mesh-sharded buckets (permutations would have to be
        identical across processes; the post-iteration reorder is skipped
        there for the same reason).

        ``rho_init``: (n, p) initial DI matrix or its (n,) per-gene max
        (the device loop fetches only the max — 8x fewer bytes)."""
        if self.mesh is not None:
            return
        if rho_init.ndim == 2:
            rho_init = rho_init.max(axis=1)
        for i, b in enumerate(self._buckets):
            safe = np.maximum(b.gene_indices, 0)
            proxy = np.where(b.gene_indices >= 0,
                             rho_init[safe], -1.0)
            perm = np.argsort(proxy, kind="stable")
            if not np.array_equal(perm, np.arange(len(perm))):
                self._permute_bucket(i, perm)

    def _reorder_by_exit_round(self, rounds_global: np.ndarray) -> None:
        """Sort each bucket's genes by how many trim rounds they survived in
        the first iteration.  Exit rounds are strongly correlated across
        DegNorm iterations, so the still-active set in later iterations
        becomes a contiguous suffix of each bucket.  The GPU kernel skips
        inactive genes one by one, so the order no longer decides what is
        skipped; its effect on the GPU is unmeasured.

        ``rounds_global``: (n,) per-gene rounds-active from the batched
        _iter_outputs fetch (padding slots carry 0, like the kernels'
        own inactive-gene output — identical ordering to the former
        per-bucket device fetches)."""
        if self.mesh is not None:
            # sharded device arrays: an eager gather along the sharded gene
            # axis would transiently replicate the largest arrays of the
            # run and disturb their placement — same guard as the presort
            return
        for i, b in enumerate(self._buckets):
            gi = b.gene_indices
            ra = np.where(gi >= 0, rounds_global[np.maximum(gi, 0)], 0.0)
            perm = np.argsort(ra, kind="stable")
            if ra.max() == 0 or np.array_equal(perm, np.arange(len(perm))):
                continue
            self._permute_bucket(i, perm)

    # -- estimates -------------------------------------------------------
    def _materialize_estimates(self) -> List[np.ndarray]:
        """Reference ``run()`` returns the final iteration's estimated
        coverage matrices (nmf.py:601), computed on coverage scaled by the
        *pre-update* scale factors of that iteration."""
        if not self._last_results:
            raise ValueError("run() has not been called")
        n = len(self._genes)
        out: List[Optional[np.ndarray]] = [None] * n

        if jax.process_count() == 1:
            # ONE device fetch for every bucket's (est_K, est_E,
            # est_kind) instead of three per bucket; the factor matrices
            # are the bulk of the post-fit transfer
            pieces, shapes = [], []
            for res in self._last_results:
                for a in (res.est_K, res.est_E, res.est_kind):
                    pieces.append(a)
                    shapes.append(tuple(a.shape))
            flat = np.asarray(_flat_concat(tuple(pieces)), np.float64)
            mats, off = [], 0
            for sh in shapes:
                sz = int(np.prod(sh))
                mats.append(flat[off:off + sz].reshape(sh))
                off += sz
            fetched = [(mats[i], mats[i + 1], mats[i + 2])
                       for i in range(0, len(mats), 3)]
        else:
            fetched = [(self._gather(r.est_K).astype(np.float64),
                        self._gather(r.est_E).astype(np.float64),
                        self._gather(r.est_kind))
                       for r in self._last_results]

        for b, (est_K, est_E, kinds) in zip(self._buckets, fetched):
            for slot, gi in enumerate(b.gene_indices):
                if gi < 0:
                    continue
                F_adj = self._cov_mats[gi] / self._final_scale[:, None]
                out[gi] = materialize_estimate(
                    F_adj, int(b.lengths[slot]), est_K[slot], est_E[slot],
                    int(kinds[slot]))
        return out
