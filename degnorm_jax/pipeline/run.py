"""End-to-end pipeline orchestration — the ``degnorm`` CLI body
(reference ``__main__.py:16-319``) on the device engine.

Cold path: BAM ETL -> merge -> gene filters -> bucketed NMF-OA on device ->
output contract.  Warm path: reload a prior run's coverage/counts and jump
straight to the device loop.
"""
from __future__ import annotations

import logging
import os
import shutil
import sys
from collections import OrderedDict
from datetime import datetime
from typing import Dict, Optional

import numpy as np

from degnorm_jax.config import PipelineConfig
from degnorm_jax.engine import DegNormEngine
from degnorm_jax.io.gtf import process_annotation
from degnorm_jax.io.merge import merge_coverage, merge_read_counts
from degnorm_jax.io.overlap import overlap_structure
from degnorm_jax.pipeline import outputs
from degnorm_jax.pipeline.sample import BamSampleProcessor
from degnorm_jax.pipeline.warm_start import load_from_previous

log = logging.getLogger("degnorm_jax")


def create_output_dir(base_dir: str) -> str:
    """Timestamped run directory, reference naming scheme
    (utils.py:49-79): degnorm_<mmddYY>_<HHMMSS>."""
    stamp = datetime.now().strftime("%m%d%Y_%H%M%S")
    out = os.path.join(base_dir, f"degnorm_{stamp}")
    os.makedirs(out, exist_ok=True)
    return out


_WELCOME = r"""
 ___   ___  ___  _  _  ___  ___  __  __
|   \ | __|| __|| \| |/ _ \| _ \|  \/  |
| |) || _| | (_ || .` | (_) |   /| |\/| |
|___/ |___||___||_|\_|\___/|_|_\|_|  |_|
     transcript degradation normalization on JAX
"""


def welcome() -> None:
    """ASCII banner (the reference's utils.py:37-46 equivalent)."""
    for line in _WELCOME.strip("\n").splitlines():
        log.info(line)


def configure_logger(output_dir: Optional[str] = None,
                     process_tag: Optional[str] = None) -> None:
    """Stream + degnorm.log file logging (utils.py:16-34 format);
    ``process_tag`` prefixes messages in multihost runs (the reference's
    rank prefix, __main_mpi__.py:33-40)."""
    tag = f"[{process_tag}] " if process_tag else ""
    fmt = logging.Formatter(f"DegNorm (%(asctime)s) ---- {tag}%(message)s")
    log.setLevel(logging.DEBUG)
    log.handlers.clear()
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(fmt)
    log.addHandler(h)
    if output_dir:
        fh = logging.FileHandler(os.path.join(output_dir, "degnorm.log"))
        fh.setFormatter(fmt)
        log.addHandler(fh)


def _shard_plot_genes(plot_genes, result_genes,
                      process_index: int = 0, process_count: int = 1):
    """This process's round-robin share of --plot-genes: case-insensitive
    intersection with the fitted genes (CoverageLoader matches
    case-insensitively, reference data_access.py:61-63), sorted for a
    deterministic split across processes (the reference scatters plot
    genes over ranks, __main_mpi__.py:461-488)."""
    canon = {g.upper(): g for g in result_genes}
    wanted = sorted({canon[g.upper()] for g in plot_genes
                     if g.upper() in canon})
    return wanted[process_index::process_count]


def _plot_gene_shard(plot_genes, result_genes, output_dir: str) -> None:
    """Plot this process's share of --plot-genes (all of them in
    single-process runs).  Reads the saved run artifacts, so the
    coordinator must have written them first."""
    import jax
    wanted = _shard_plot_genes(plot_genes, result_genes,
                               jax.process_index(), jax.process_count())
    if not wanted:
        return
    log.info("plotting coverage for %d gene(s): %s",
             len(wanted), ", ".join(wanted))
    try:
        from degnorm_jax.report.data_access import get_coverage_plots
        get_coverage_plots(wanted, degnorm_dir=output_dir,
                           save_dir=output_dir)
    except Exception as e:   # plots must never fail the pipeline
        log.warning("coverage plotting failed: %s", e)


def run_pipeline(cfg: PipelineConfig, output_dir: Optional[str] = None,
                 mesh=None, write_outputs: bool = True) -> Dict:
    """Run the full DegNorm pipeline; returns a dict with the fit result,
    gene tables, and the output directory path.

    ``mesh``: optional device mesh for gene-sharded execution (single- or
    multi-host; see parallel/).
    ``write_outputs``: False on multihost worker processes — the
    coordinator owns every artifact in the (shared) output directory;
    workers keep ETL scratch in a process-private subdirectory and skip
    final outputs/plots/report.

    The returned dict carries a ``timings`` mapping with wall-clock
    seconds per phase (etl, filters, fit, estimates, save, plots,
    report) — the whole-pipeline observability the reference lacks
    (its only visibility is log timestamps, SURVEY.md §5.1)."""
    import time as _time
    timings: Dict[str, float] = {}
    _t0 = _time.perf_counter()
    output_dir = output_dir or create_output_dir(cfg.output_dir)

    if cfg.warm_start_dir:
        log.info("WARM START: loading preprocessed data from %s",
                 cfg.warm_start_dir)
        warm = load_from_previous(cfg.warm_start_dir, output_dir,
                                  copy_artifacts=write_outputs)
        gene_cov_dict = warm["gene_cov_dict"]
        read_count_df = warm["read_count_df"]
        genes_df = warm["genes_df"]
        sample_ids = warm["sample_ids"]
        exon_df = warm["exon_df"]
    else:
        gene_cov_dict, read_count_df, genes_df, exon_df, sample_ids = (
            _cold_start(cfg, output_dir, write_outputs=write_outputs,
                        mesh=mesh))
    timings["etl"] = _time.perf_counter() - _t0

    # ---- gene filters before NMF (reference __main__.py:221-238, plus the
    # MPI-only caps __main_mpi__.py:374-376, unified per SURVEY.md §7.2) ----
    _t0 = _time.perf_counter()
    drop = []
    for gene, F in gene_cov_dict.items():
        too_low = F.max() < cfg.minimax_coverage
        too_short = F.shape[1] <= cfg.nmf.downsample_rate
        too_long = F.shape[1] > cfg.max_gene_length
        too_high = F.max() > cfg.max_coverage
        if too_low or too_short or too_long or too_high:
            drop.append(gene)
    for gene in drop:
        del gene_cov_dict[gene]
    if drop:
        genes_df = genes_df[~genes_df.gene.isin(drop)].reset_index(drop=True)
        read_count_df = read_count_df[
            ~read_count_df.gene.isin(drop)].reset_index(drop=True)
    if not gene_cov_dict:
        raise ValueError("No genes available to run through DegNorm!")

    log.info("DegNorm will run on %d genes across %d samples.",
             len(gene_cov_dict), len(sample_ids))
    timings["filters"] = _time.perf_counter() - _t0

    # ---- the device loop ----
    # Warm the plotting stack on a background thread while the device fit
    # runs: matplotlib+seaborn+pandas imports cost ~6 s on this image and
    # used to land inside the serial report phase; the fit is device-bound
    # (GIL released), so the import is free here.
    import threading as _threading

    def _warm_plot_stack():
        try:
            import degnorm_jax.report.report  # noqa: F401
        except Exception:                      # pragma: no cover
            pass
    _threading.Thread(target=_warm_plot_stack, daemon=True).start()

    _t0 = _time.perf_counter()
    engine = DegNormEngine(cfg.nmf, cfg.engine, mesh=mesh)
    counts = read_count_df[sample_ids].values.astype(np.float64)
    # checkpoint_dir goes to every process (all resume from the shared
    # file); saving is coordinator-gated inside save_checkpoint
    result = engine.run(gene_cov_dict, counts, checkpoint_dir=output_dir)
    timings["fit"] = _time.perf_counter() - _t0
    timings.update({f"fit.{k}": v for k, v in engine.timings.items()})

    # materialize estimates on EVERY process: on a multi-process mesh this
    # is an allgather collective, so workers must participate before the
    # coordinator-only output writing below (skipping it deadlocks both)
    _t0 = _time.perf_counter()
    estimates = OrderedDict(zip(result.genes, result.estimates()))
    timings["estimates"] = _time.perf_counter() - _t0

    if not write_outputs:
        # multihost worker: plotting is scattered across processes (the
        # reference scatters --plot-genes over ranks, __main_mpi__.py:
        # 461-488) — wait for the coordinator's artifacts, then plot this
        # process's share straight into the shared output directory
        if cfg.plot_genes:
            from degnorm_jax.parallel.distributed import barrier
            barrier("degnorm-outputs-written")
            _plot_gene_shard(cfg.plot_genes, result.genes, output_dir)
        return {"result": result, "genes_df": genes_df,
                "read_count_df": read_count_df, "sample_ids": sample_ids,
                "output_dir": output_dir, "exon_df": exon_df,
                "timings": timings}

    # ---- outputs (reference nmf.py:603-711 contract) ----
    # The summary report renders CONCURRENTLY with the artifact writes:
    # with in-memory rho (DI figures) and coverage/estimates (gene
    # figures) it reads nothing save_results is writing, and the phases
    # touch disjoint files.  The reference runs them serially
    # (__main__.py:283-316); at 20k genes that was ~11 s of tail latency.
    _t_rep0 = _time.perf_counter()
    rep_done = {}

    def _report_job():
        try:
            from degnorm_jax.report.report import render_report
            render_report(
                data_dir=output_dir,
                degnorm_data={"degnorm_iter": cfg.nmf.degnorm_iter,
                              "nmf_iter": cfg.nmf.nmf_iter,
                              "downsample_rate": cfg.nmf.downsample_rate,
                              "rho": result.rho, "genes": result.genes},
                bam_files=(list(cfg.bam_files) if not cfg.warm_start_dir
                           else [cfg.warm_start_dir]),
                sample_ids=sample_ids, top_n_genes=5,
                output_dir=output_dir,
                # reuse the arrays already in memory: no re-unpickling of
                # the artifacts being written next door
                cov_data={"raw": gene_cov_dict, "estimate": estimates},
                exon_df=exon_df)
        except Exception as e:
            log.warning("report rendering failed: %s", e)
        rep_done["wall"] = _time.perf_counter() - _t_rep0
    rep_thread = _threading.Thread(target=_report_job, daemon=True)
    rep_thread.start()

    _t0 = _time.perf_counter()
    gene_chrom = dict(zip(genes_df.gene, genes_df.chr))
    outputs.save_results(
        output_dir, result.genes, gene_chrom, result.rho, result.x_adj,
        result.ran_baseline_selection, estimates, sample_ids)
    timings["save"] = _time.perf_counter() - _t0

    if cfg.plot_genes:
        _t0 = _time.perf_counter()
        from degnorm_jax.parallel.distributed import barrier
        barrier("degnorm-outputs-written")
        _plot_gene_shard(cfg.plot_genes, result.genes, output_dir)
        timings["plots"] = _time.perf_counter() - _t0

    # "report" = tail latency beyond the save/plot phases it overlapped;
    # "report_render" = the render's own wall for comparison
    _t0 = _time.perf_counter()
    rep_thread.join()
    timings["report"] = _time.perf_counter() - _t0
    timings["report_render"] = rep_done.get("wall", 0.0)
    log.info("pipeline phase timings (s): %s",
             {k: round(v, 2) for k, v in timings.items()})

    return {"result": result, "genes_df": genes_df,
            "read_count_df": read_count_df, "sample_ids": sample_ids,
            "output_dir": output_dir, "exon_df": exon_df,
            "timings": timings}


def _cold_start(cfg: PipelineConfig, output_dir: str,
                write_outputs: bool = True, mesh=None):
    """BAM/GTF ETL (reference __main__.py:55-209)."""
    if not cfg.bam_files:
        raise ValueError("no .bam files supplied")
    if not cfg.genome_annotation:
        raise ValueError("no genome annotation (.gtf) supplied")

    # multihost: .bam files are split across processes (the reference
    # scatters them over MPI ranks, __main_mpi__.py:236-262) and the
    # per-(sample, chrom) artifacts on the shared filesystem are the
    # transport (the reference likewise hands coverage off through the
    # shared FS, __main_mpi__.py:400-416).  Sample ownership is disjoint,
    # so writes into the shared scratch never collide.
    pcount, pindex = 1, 0
    if mesh is not None or not write_outputs:
        # only consult jax when a mesh already exists / we are a multihost
        # worker — plain single-process runs must not initialize a device
        # backend during ETL
        import jax
        pcount, pindex = jax.process_count(), jax.process_index()
    etl_dir = output_dir
    if pcount > 1:
        etl_dir = os.path.join(output_dir, ".etl_shared")
        os.makedirs(etl_dir, exist_ok=True)

    bais = (list(cfg.bai_files) if cfg.bai_files
            else [None] * len(cfg.bam_files))
    if len(bais) != len(cfg.bam_files):
        # strict pairing, like the reference's flag validation
        # (utils.py:318-484) — a shorter list would silently drop samples
        raise ValueError(
            f"--bai-files count ({len(bais)}) does not match .bam count "
            f"({len(cfg.bam_files)})")
    samples = [BamSampleProcessor(b, unique_alignment=cfg.unique_alignments,
                                  output_dir=etl_dir,
                                  compat=cfg.cigar_compat, bai_file=bai,
                                  # non-owned samples are loaded from the
                                  # owner's artifacts, never decoded here —
                                  # stream=False also keeps this process
                                  # from racing the owner on .bai builds
                                  stream=(cfg.stream_etl
                                          if i % pcount == pindex else False))
               for i, (b, bai) in enumerate(zip(cfg.bam_files, bais))]
    sample_ids = [s.sample_id for s in samples]
    if len(set(sample_ids)) < len(sample_ids):
        raise ValueError("duplicate sample IDs among .bam files")

    # chromosomes: intersection of all samples' headers, restricted to the
    # annotation (reference __main__.py:87-99)
    chroms = set(samples[0].chroms)
    for s in samples[1:]:
        chroms &= set(s.chroms)
    exon_df = process_annotation(cfg.genome_annotation,
                                 chroms=sorted(chroms))
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)

    used_chroms = exon_df.chr.unique().tolist()
    overlap_by_chrom = {
        c: overlap_structure(gene_df[gene_df.chr == c]) for c in used_chroms}

    # samples in parallel host threads (BGZF/BAM decode is native and
    # releases the GIL); each sample additionally threads over chromosomes
    from concurrent.futures import ThreadPoolExecutor

    owned = [s for i, s in enumerate(samples) if i % pcount == pindex]
    if pcount > 1:
        log.info("multihost ETL: this process owns %d/%d sample(s): %s",
                 len(owned), len(samples),
                 ", ".join(s.sample_id for s in owned) or "(none)")

    # -p is a TOTAL host-thread budget (the reference's proc-per-node):
    # split it between the sample fan-out and each sample's per-chromosome
    # threads so p samples don't oversubscribe to n_jobs^2 threads
    sample_workers = min(cfg.n_jobs, max(len(owned), 1))
    inner_jobs = max(1, cfg.n_jobs // max(sample_workers, 1))

    def etl(s: BamSampleProcessor):
        s.chroms = used_chroms
        log.info("SAMPLE %s: computing coverage/read counts (%s)",
                 s.sample_id, "paired" if s.paired else "single-end")
        return s.sample_id, s.coverage_read_counts(
            overlap_by_chrom, gene_df, exon_df, n_jobs=inner_jobs)

    results = {}
    if sample_workers > 1 and len(owned) > 1:
        with ThreadPoolExecutor(max_workers=sample_workers) as ex:
            for sid, r in ex.map(etl, owned):
                results[sid] = r
    else:
        for s in owned:
            sid, r = etl(s)
            results[sid] = r

    if pcount > 1:
        # every owner has written its artifacts; load the peers' shards
        # from the shared scratch (coverage_read_counts becomes a pure
        # artifact load when everything exists)
        from degnorm_jax.parallel.distributed import barrier
        barrier("degnorm-etl-shards")
        for i, s in enumerate(samples):
            if i % pcount == pindex:
                continue
            s.chroms = used_chroms
            log.info("SAMPLE %s: loading peer shard from shared ETL scratch",
                     s.sample_id)
            results[s.sample_id] = s.coverage_read_counts(
                overlap_by_chrom, gene_df, exon_df, n_jobs=inner_jobs)

    read_count_df = merge_read_counts(results, sample_ids, used_chroms)
    gene_cov_dict = merge_coverage(results, sample_ids, exon_df)

    # clean up per-sample scratch (reference __main__.py:168-170); in
    # multihost runs the shared scratch outlives the barrier so every
    # process has loaded all shards before the coordinator removes it
    if pcount > 1:
        barrier("degnorm-etl-consumed")
        if write_outputs:
            shutil.rmtree(etl_dir, ignore_errors=True)
    else:
        for sid in sample_ids:
            scratch = os.path.join(etl_dir, sid)
            if os.path.isdir(scratch):
                shutil.rmtree(scratch)

    # order counts/genes by coverage-dict order (reference __main__.py:175-190)
    genes = list(gene_cov_dict.keys())
    genes_df = (gene_df.set_index("gene").loc[genes].reset_index()
                [["chr", "gene", "gene_start", "gene_end"]])
    read_count_df = (read_count_df.set_index("gene").loc[genes].reset_index()
                     [["gene", "chr"] + sample_ids])
    read_count_df = read_count_df[["chr", "gene"] + sample_ids]
    exon_df = exon_df[exon_df.gene.isin(genes)]

    # save gene annotation metadata + raw read counts (__main__.py:199-209)
    if write_outputs:
        exon_df.to_csv(os.path.join(output_dir, "gene_exon_metadata.csv"),
                       index=False)
        # reference column order is gene-first: __main__.py:181-190 runs
        # set_index('gene')/loc[genes]/reset_index before the save
        rc_cols = (["gene"] + [c for c in read_count_df.columns
                               if c != "gene"])
        read_count_df[rc_cols].to_csv(
            os.path.join(output_dir, "read_counts.csv"), index=False)

        # raw coverage matrices pickles (reads_coverage_merge.py:439-452)
        gene_chrom = dict(zip(genes_df.gene, genes_df.chr))
        outputs.save_coverage_matrices(output_dir, gene_chrom,
                                       gene_cov_dict)

    return gene_cov_dict, read_count_df, genes_df, exon_df, sample_ids
