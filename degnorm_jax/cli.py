"""``degnorm-jax`` command line interface.

Flag set mirrors the reference's argparser (``utils.py:195-315``) so
existing DegNorm invocations port directly; the MPI launcher is replaced by
the same binary running under ``jax.distributed`` (see parallel/), so there
is no separate ``degnorm_mpi`` entry point.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

from degnorm_jax import __version__
from degnorm_jax.config import EngineConfig, NMFConfig, PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="degnorm-jax",
        description="RNA-seq degradation normalization (DegNorm) on JAX")
    p.add_argument("--bam-files", nargs="+", default=None,
                   help="aligned read files (.bam or .cram; CRAM decodes "
                        "without a reference FASTA)")
    p.add_argument("--bai-files", nargs="+", default=None,
                   help=".bam index files (optional — the streaming reader "
                        "does not require them; accepted for compatibility)")
    p.add_argument("--bam-dir", default=None,
                   help="directory to scan for .bam files")
    p.add_argument("-w", "--warm-start-dir", default=None,
                   help="previous run's output directory to resume from")
    p.add_argument("-g", "--genome-annotation", default=None,
                   help="genome annotation file (.gtf)")
    p.add_argument("-o", "--output-dir", default=".",
                   help="where to create the run output directory")
    p.add_argument("--plot-genes", nargs="+", default=None,
                   help="genes to plot coverage for (names or .txt files)")
    p.add_argument("-d", "--downsample-rate", type=int, default=1)
    p.add_argument("--nmf-iter", type=int, default=100)
    p.add_argument("--iter", type=int, default=5, dest="degnorm_iter")
    p.add_argument("--minimax-coverage", type=int, default=0)
    p.add_argument("-s", "--skip-baseline-selection", action="store_true")
    p.add_argument("--non-unique-alignments", action="store_true",
                   help="keep reads with NH > 1")
    p.add_argument("-p", "--proc-per-node", type=int, default=1,
                   help="host threads for ETL")
    p.add_argument("--stream-etl", default=None, choices=["auto", "on", "off"],
                   help="BAI-driven per-chromosome streaming ETL "
                        "(memory bounded by the largest chromosome); "
                        "default auto: stream large indexed BAMs")
    p.add_argument("--multihost", action="store_true",
                   help="initialize jax.distributed (DEGNORM_JAX_* env "
                        "vars) and shard genes over all hosts' devices")
    p.add_argument("--mesh", action="store_true",
                   help="shard genes over all local devices")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--rank1-method", default="power",
                   choices=["power", "eigh"])
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the DegNorm "
                        "iterations into this directory (TensorBoard/xprof)")
    p.add_argument("--nmf-tol", type=float, default=0.0,
                   help="adaptive NMF convergence: freeze a gene's factors "
                        "once its K stops moving by more than this relative "
                        "tolerance (0 = reference behavior, always nmf-iter "
                        "iterations; documented opt-in deviation — see "
                        "PARITY.md)")
    p.add_argument("--ds-compat", default="keyed",
                   choices=["keyed", "reference"],
                   help="downsample-offset RNG: 'keyed' (default; "
                        "deterministic per-gene JAX PRNG, the documented "
                        "fix of the reference's thread-racy global numpy "
                        "RNG) or 'reference' (reproduce the reference's "
                        "exact np.random.seed(123) offset stream, its "
                        "n_jobs=1 behavior — for artifact parity runs)")
    p.add_argument("-v", "--version", action="version",
                   version=f"degnorm-jax {__version__}")
    return p


def expand_plot_genes(vals: Optional[List[str]]) -> List[str]:
    """Gene names and/or .txt files of gene names (utils.py:346-361)."""
    if not vals:
        return []
    genes: List[str] = []
    for v in vals:
        if v.endswith(".txt") and os.path.isfile(v):
            with open(v) as f:
                genes.extend(x.strip() for x in f.read().split() if x.strip())
        else:
            genes.append(v)
    return list(dict.fromkeys(genes))


def parse_config(argv: Optional[List[str]] = None,
                 return_args: bool = False):
    args = build_parser().parse_args(argv)

    # cap -p at the host's core count (reference utils.py:327-332 caps at
    # max_cpu = cores-1 with a warning; we warn and cap the same way)
    max_ppn = max(1, (os.cpu_count() or 2) - 1)
    if args.proc_per_node > max_ppn:
        import warnings
        warnings.warn(f"-p {args.proc_per_node} exceeds the available "
                      f"cores; reducing to {max_ppn}.")
        args.proc_per_node = max_ppn

    # output directory must already exist (utils.py:334-336; the run
    # creates a timestamped subdirectory inside it)
    if not os.path.isdir(args.output_dir):
        raise SystemExit(f"Cannot find output directory {args.output_dir} "
                         "for saving output")

    # numeric flag validation (reference utils.py:343-344)
    if (args.nmf_iter < 1 or args.degnorm_iter < 1
            or args.downsample_rate < 1):
        raise SystemExit("--nmf-iter, --iter, and --downsample-rate must "
                         "all be >= 1.")

    if args.warm_start_dir:
        # utils.py:365-379: validate the directory and ignore any
        # simultaneously-supplied alignment/annotation inputs (warned)
        if not os.path.isdir(args.warm_start_dir):
            raise SystemExit(
                f"Cannot find --warm-start-dir {args.warm_start_dir}")
        if args.bam_files or args.bam_dir or args.genome_annotation:
            import logging
            logging.getLogger("degnorm_jax").warning(
                "Using warm-start directory. Supplied .bam files, .bam "
                "directory, and genome annotation file will be ignored.")
        args.bam_files = args.bai_files = args.bam_dir = None
        args.genome_annotation = None
    # input selection methods are mutually exclusive (utils.py:398-403)
    if args.bam_dir and (args.bam_files or args.bai_files):
        raise SystemExit("Do not specify both a --bam-dir and either "
                         "--bam-files and/or --bai-files.")
    for b in args.bam_files or []:
        if not b.endswith((".bam", ".cram")):   # utils.py:434-436
            raise SystemExit(f"{b} is not a .bam or .cram file.")

    bam_files = list(args.bam_files or [])
    if args.bam_dir:
        if not os.path.isdir(args.bam_dir):
            raise SystemExit(f"Cannot find --bam-dir {args.bam_dir}")
        bam_files.extend(sorted(
            glob.glob(os.path.join(args.bam_dir, "*.bam"))
            + glob.glob(os.path.join(args.bam_dir, "*.cram"))))
    if not args.warm_start_dir:
        if not bam_files:
            raise SystemExit("no .bam/.cram files supplied "
                             "(--bam-files / --bam-dir / --warm-start-dir)")
        if len(bam_files) < 2:
            raise SystemExit("DegNorm requires >= 2 RNA-seq samples")
        if not args.genome_annotation:
            raise SystemExit("a genome annotation .gtf is required (-g)")
        missing = [b for b in bam_files if not os.path.isfile(b)]
        if missing:
            raise SystemExit(f"missing .bam/.cram files: {missing}")
        if len(bam_files) != len(set(bam_files)):   # utils.py:478-480
            raise SystemExit("Supplied .bam files are not uniquely named!")
        if args.bai_files:
            # utils.py:443-457: count must match, files must be .bai and
            # exist (the native reader can also build indexes itself)
            if len(args.bai_files) != len(bam_files):
                raise SystemExit("Number of supplied .bai files does not "
                                 "match number of supplied .bam files.")
            for bai in args.bai_files:
                if not bai.endswith(".bai"):
                    raise SystemExit(f"{bai} is not a .bai file.")
                if not os.path.isfile(bai):
                    raise SystemExit(f"Could not find .bai file {bai}")

    nmf = NMFConfig(
        degnorm_iter=args.degnorm_iter, nmf_iter=args.nmf_iter,
        downsample_rate=args.downsample_rate,
        skip_baseline_selection=args.skip_baseline_selection,
        ds_compat=args.ds_compat)
    eng = EngineConfig(dtype=args.dtype, rank1_method=args.rank1_method,
                       nmf_tol=args.nmf_tol,
                       profile_dir=args.profile_dir)
    cfg = PipelineConfig(
        bam_files=tuple(bam_files),
        bai_files=tuple(args.bai_files or []),
        genome_annotation=args.genome_annotation,
        output_dir=args.output_dir,
        plot_genes=tuple(expand_plot_genes(args.plot_genes)),
        warm_start_dir=args.warm_start_dir,
        minimax_coverage=args.minimax_coverage,
        unique_alignments=not args.non_unique_alignments,
        stream_etl={"on": True, "off": False,
                    "auto": None, None: None}[args.stream_etl],
        n_jobs=args.proc_per_node,
        nmf=nmf, engine=eng)
    return (cfg, args) if return_args else cfg


def main(argv: Optional[List[str]] = None) -> int:
    from degnorm_jax.pipeline.run import (configure_logger, create_output_dir,
                                          run_pipeline, welcome)
    cfg, args = parse_config(argv, return_args=True)

    mesh = None
    coordinator = True
    if args.multihost:
        from degnorm_jax.parallel.distributed import (broadcast_string,
                                                      global_mesh,
                                                      initialize_multihost,
                                                      is_coordinator)
        initialize_multihost()
        mesh = global_mesh()
        import jax
        if jax.process_count() > 1:
            # coordinator owns the run directory and every artifact write;
            # its timestamped name is broadcast so all processes agree
            # (the reference bcasts its output dir, __main_mpi__.py:62-71)
            coordinator = is_coordinator()
            output_dir = broadcast_string(
                create_output_dir(cfg.output_dir) if coordinator else "")
            if not coordinator:
                os.makedirs(output_dir, exist_ok=True)
            configure_logger(output_dir if coordinator else None,
                             process_tag=f"rank {jax.process_index()}")
            welcome()
            run_pipeline(cfg, output_dir=output_dir, mesh=mesh,
                         write_outputs=coordinator)
            return 0
    elif args.mesh:
        from degnorm_jax.parallel.sharded import make_mesh
        mesh = make_mesh()

    output_dir = create_output_dir(cfg.output_dir)
    configure_logger(output_dir)
    welcome()
    run_pipeline(cfg, output_dir=output_dir, mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
