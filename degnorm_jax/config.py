"""Typed configuration for the DegNorm engine.

Replaces the reference's argparse flags (reference ``degnorm/utils.py:195-315``)
and the constants hard-coded inside ``GeneNMFOA.__init__``
(reference ``degnorm/nmf.py:12-53``) with a single frozen dataclass, per the
survey's recommendation (SURVEY.md §5.6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class NMFConfig:
    """Parameters of the NMF-over-approximation algorithm.

    Defaults mirror reference ``degnorm/nmf.py:12-13`` exactly.
    """

    degnorm_iter: int = 5          # outer DegNorm iterations
    nmf_iter: int = 100            # Lagrangian fixed-point iterations per NMF call
    downsample_rate: int = 1       # systematic "take every r-th" column sample
    min_high_coverage: int = 50    # min # of high-coverage positions to attempt NMF
    bins: int = 20                 # baseline-selection trim bins
    skip_baseline_selection: bool = False
    random_state: int = 123
    # Systematic-downsample offset source (only meaningful when
    # downsample_rate > 1):
    #   "keyed"     (default) — per-(seed, iteration, gene) JAX PRNG keys;
    #               deterministic, permutation/resume/mesh-invariant (the
    #               documented fix of the reference's thread-racy global
    #               numpy RNG, SURVEY.md §2.2).
    #   "reference" — reproduce the reference's EXACT offset stream: one
    #               np.random.choice(rate) per gene per iteration in gene
    #               order from np.random.seed(123) (nmf.py:422,556), which
    #               is the reference's deterministic behavior at n_jobs=1.
    #               Opt-in, for all-up artifact parity runs
    #               (tests/test_twin_run.py); PARITY.md §known deviations.
    ds_compat: str = "keyed"

    def __post_init__(self):
        object.__setattr__(self, "degnorm_iter", abs(int(self.degnorm_iter)))
        object.__setattr__(self, "nmf_iter", abs(int(self.nmf_iter)))
        object.__setattr__(self, "bins", abs(int(self.bins)))
        object.__setattr__(self, "downsample_rate", abs(int(self.downsample_rate)))

    @property
    def effective_min_high_coverage(self) -> int:
        # Reference forces this to 2 whenever downsampling (nmf.py:34,51-53),
        # otherwise max(2, min_high_coverage).
        if self.downsample_rate > 1:
            return 2
        return max(2, abs(int(self.min_high_coverage)))

    @property
    def min_bins(self) -> int:
        # ceil(bins * 0.2)  (nmf.py:35)
        return int(math.ceil(self.bins * 0.2))

    @property
    def min_gene_len(self) -> int:
        # max(2, ceil(200 / downsample_rate))  (nmf.py:261)
        return max(2, int(math.ceil(200.0 / self.downsample_rate)))

    def kernel_key(self) -> "NMFConfig":
        """Normalized copy for use as a jit static argument: fields that do
        not affect the device kernel (outer-iteration count, RNG seed,
        offset source — offsets enter the kernel as data) are zeroed so
        warm-up runs and production runs share compile caches."""
        return dataclasses.replace(self, degnorm_iter=0, random_state=0,
                                   ds_compat="keyed")

    @property
    def max_trim_rounds(self) -> int:
        """Upper bound on baseline-selection trim-loop rounds.

        Each round drops exactly one bin and the loop halts at ``min_bins``
        bins (nmf.py:323), so at most ``bins - min_bins`` drops occur — 16 at
        the defaults.  Our device kernel runs a bounded masked loop of this
        length (SURVEY.md §7.2).
        """
        return max(self.bins - self.min_bins, 1)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Device-execution knobs of the engine (no reference equivalent)."""

    # Power-iteration steps for the dominant eigenpair of the p x p Gram
    # matrix on a cold start and when warm-started from the previous
    # Lagrangian iteration's vector.  Long sparse genes can have slowly
    # separating singular values; these counts hold DI parity to ~1e-4 at
    # negligible cost (power steps are O(p²) vs the O(p²W) Gram).
    power_iters_cold: int = 128
    power_iters_warm: int = 24
    # Cold-start power iterations for trim rounds >= 1, which warm-start
    # from the previous round's left vector. Dropping one bin perturbs the
    # Gram slightly, so the previous Perron vector is an excellent initial
    # guess and far fewer iterations reach the same fixed point (the
    # target is unique — not a numerics deviation).
    power_iters_resume: int = 32
    # Dominant-eigenpair extraction on the p x p Gram matrix: "power"
    # (warm-started power iteration, the device path) or "eigh" (exact
    # batched eigendecomposition, parity/debug path).
    rank1_method: str = "power"
    # Route the NMF-OA loop through the Pallas GPU kernel (ops/nmf_gpu.py)
    # on a GPU.  Buckets the kernel's gate refuses (ops/nmf_gpu.py::
    # kernel_supported), method="eigh", float64 and nmf_tol > 0 take the
    # XLA loop.  On CPU the XLA loop always runs unless pallas_interpret.
    use_pallas: bool = True
    # Run the GPU kernel in the Pallas interpreter (CPU testing only).
    pallas_interpret: bool = False
    # OPT-IN adaptive convergence for the NMF-OA Lagrangian loop (0.0 =
    # off, the reference semantics: always exactly nmf_iter iterations).
    # With nmf_tol > 0, a gene FREEZES its (X, K, E, u) state once its K
    # factor's max-abs change in one iteration falls below nmf_tol
    # relative to max|K|, and the loop exits early when every gene of the
    # batch has frozen (capped at nmf_iter).  Freezing is per-gene and
    # depends only on that gene's own history, so results are invariant to
    # batching.  A numeric deviation — measured drift is documented in
    # PARITY.md §known deviations.  Runs on the XLA loop only.
    nmf_tol: float = 0.0
    # Computation dtype on device (float32); the golden oracle runs
    # float64 on host for parity gating.
    dtype: str = "float32"
    # Length-bucket edges used by the packer (positions). Genes are padded to
    # the smallest bucket width >= L_i; every width is a power of two (the
    # GPU kernel's block shapes must be).
    bucket_widths: Sequence[int] = (256, 512, 1024, 2048, 4096, 8192, 16384, 65536)
    # Cap on genes per device batch within one bucket; 0 = unbounded (one
    # batch per width — fewest dispatches; gene counts are ladder-quantized
    # so compiled shapes still recur across similar-sized datasets).
    max_genes_per_batch: int = 0
    # Gene-data-parallel mesh axis name.
    mesh_axis: str = "genes"
    # Buckets at least this wide switch from gene sharding to COLUMN
    # (position-axis) sharding over the mesh — the sequence-parallel path
    # for outlier-length genes (SURVEY.md §5.7: the reference instead caps
    # genes at 9 Mb and downsamples). Rank-1/row-sum/colmax reductions are
    # all column-partitionable, so GSPMD inserts one small collective per
    # reduction; such buckets run on the XLA path, which shards
    # transparently.
    seqpar_width: int = 32768
    # When set, capture a jax.profiler trace of the DegNorm iterations into
    # this directory (viewable with TensorBoard / xprof). The reference has
    # no tracing at all (SURVEY.md §5.1).
    profile_dir: Optional[str] = None
    # Outer-loop location. None (default, since round 4) = the device-
    # resident loop: all global updates on device (jnp/df twins of
    # core/degnorm.py), zero per-iteration host syncs — the fastest
    # measured configuration, f64-grade via outer_df.  False = the host
    # float64 loop (the original parity reference) — except on multi-
    # process meshes, where the device loop is mandatory (per-bucket
    # results cannot be host-materialized) and False is overridden.
    # True = device loop explicitly.
    device_loop: Optional[bool] = None
    # Run the device loop's outer updates in two-float32 compensated
    # arithmetic (core/dfloat.py, ~49 significand bits), instead of plain
    # engine-dtype f32 (whose ~1e-6 per-op rounding amplified to 4e-2
    # adjusted-count drift through borderline-trim feedback in round 3).  The df
    # ops are a handful of elementwise passes over O(n*p)-kilobyte arrays
    # — invisible next to the bucket kernels.
    outer_df: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline options — the typed replacement for the CLI flag
    set validated in reference ``degnorm/utils.py:318-484``."""

    bam_files: Sequence[str] = ()
    bai_files: Sequence[str] = ()
    genome_annotation: Optional[str] = None
    output_dir: str = "."
    plot_genes: Sequence[str] = ()
    warm_start_dir: Optional[str] = None
    # Gene filters applied before NMF (reference __main__.py:221-238 and the
    # MPI-only caps __main_mpi__.py:374-376, unified here per SURVEY.md §7.2).
    minimax_coverage: int = 0
    max_gene_length: int = 9_000_000
    # reference drops genes with max coverage > 2147483647 (2^31 - 1,
    # __main_mpi__.py:377), not > 2^31
    max_coverage: float = float(2 ** 31 - 1)
    unique_alignments: bool = True
    # CIGAR/pairing semantics: "reference" reproduces the reference
    # implementation's parser quirks exactly (needed for bitwise coverage
    # parity); "strict" follows the SAM spec (io/coverage.py docstring).
    cigar_compat: str = "reference"
    # BAI-driven per-chromosome streaming ETL: None = auto (stream when an
    # index exists and the BAM exceeds BamSampleProcessor.STREAM_THRESHOLD),
    # True/False = force. Streaming bounds host memory by the largest
    # chromosome instead of the whole file.
    stream_etl: Optional[bool] = None
    n_jobs: int = 1
    nmf: NMFConfig = dataclasses.field(default_factory=NMFConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
