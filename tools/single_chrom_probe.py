"""Single-chromosome ETL probe (round-5 verdict item 3): one sample, one
contig, N reads (default 20M) through the full per-sample ETL
(decode -> pairing -> coverage -> counts -> artifact writes), timing the
whole pass and the coverage phase.  The dataset caches under --data-dir.

    python tools/single_chrom_probe.py [--reads 20000000] [--jobs 4]
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int,
                    default=int(os.environ.get("PROBE_READS", 20_000_000)))
    ap.add_argument("--genes", type=int, default=2000)
    ap.add_argument("--jobs", type=int,
                    default=max(1, (os.cpu_count() or 2)))
    ap.add_argument("--data-dir", default=os.path.join(
        tempfile.gettempdir(), "dn_single_chrom_probe"))
    ap.add_argument("--paired", action="store_true")
    args = ap.parse_args()

    from degnorm_jax.io.simulate import make_genes, write_gtf, \
        write_sample_bam
    os.makedirs(args.data_dir, exist_ok=True)
    tag = f"one_{args.reads}" + ("_pe" if args.paired else "")
    bam = os.path.join(args.data_dir, f"{tag}.bam")
    gtf = os.path.join(args.data_dir, f"{tag}.gtf")
    rng = np.random.default_rng(9)
    genes = make_genes(rng, n_genes=args.genes, overlap_fraction=0.15)
    if not os.path.isfile(bam):
        t0 = time.time()
        write_gtf(gtf, genes)
        chrom_len = max(e for g in genes for _, e in g.exons) + 10_000
        write_sample_bam(bam, genes, chrom_len, seed=123,
                         mean_reads_per_gene=(args.reads // args.genes
                                              // (2 if args.paired else 1)),
                         paired=args.paired)
        print(f"[probe] dataset built in {time.time()-t0:.0f}s "
              f"({os.path.getsize(bam)/1e6:.0f} MB)", flush=True)

    from degnorm_jax.io.gtf import process_annotation
    from degnorm_jax.io.overlap import overlap_structure
    from degnorm_jax.pipeline.sample import BamSampleProcessor

    exon_df = process_annotation(gtf)
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = {c: overlap_structure(gene_df[gene_df.chr == c])
          for c in gene_df.chr.unique()}

    out = os.path.join(args.data_dir, "out")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.time()
    proc = BamSampleProcessor(bam, output_dir=out)
    t_hdr = time.time() - t0
    t0 = time.time()
    res = proc.coverage_read_counts(ov, gene_df, exon_df,
                                    n_jobs=args.jobs)
    dt = time.time() - t0
    n_counted = sum(sum(cc.read_counts.values()) for cc in res.values())
    print(f"[probe] header+init {t_hdr:.1f}s; "
          f"ETL {dt:.1f}s at jobs={args.jobs} "
          f"({args.reads/dt/1e6:.2f} M reads/s); "
          f"counted {n_counted}", flush=True)


if __name__ == "__main__":
    main()
