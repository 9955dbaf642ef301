"""Whole-pipeline benchmark: the reference's unit of account is ONE linear
run (BAM -> coverage -> NMF-OA -> save -> plots -> report, reference
__main__.py:16-319); this tool times `degnorm-jax` the same way, cold,
at real scale, and prints the per-phase wall-clock split.

Dataset (cached under --data-dir): 20,480 genes with multi-exon structure
and overlap groups across 8 chromosomes; 8 samples x ~2M aligned reads
(mean 100 reads/gene), half the samples degraded.  Run:

    python tools/pipeline_bench.py              # generate + run
    python tools/pipeline_bench.py --skip-run   # just generate/cache

The CLI is invoked as a real subprocess (`python -m degnorm_jax ...`) so
the number includes interpreter + device-session startup the way a user
pays it; the per-phase split is parsed from the pipeline's own timings
log line (pipeline/run.py).
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_CHROM = int(os.environ.get("PIPE_CHROMS", 8))
GENES_PER_CHROM = int(os.environ.get("PIPE_GENES_PER_CHROM", 2560))
N_SAMPLES = int(os.environ.get("PIPE_SAMPLES", 8))
READS_PER_GENE = int(os.environ.get("PIPE_READS_PER_GENE", 100))


def build_dataset(data_dir: str) -> dict:
    from degnorm_jax.io.simulate import (make_genes, write_gtf,
                                         write_multichrom_bam)
    os.makedirs(data_dir, exist_ok=True)
    manifest = os.path.join(data_dir, "manifest.json")
    params = dict(chroms=N_CHROM, gpc=GENES_PER_CHROM, samples=N_SAMPLES,
                  rpg=READS_PER_GENE, v=2)
    if os.path.isfile(manifest):
        with open(manifest) as f:
            m = json.load(f)
        if m.get("params") == params and all(
                os.path.isfile(os.path.join(data_dir, b))
                for b in m["bams"] + [m["gtf"]]):
            print(f"[pipe] dataset cached in {data_dir}", file=sys.stderr)
            return m
    rng = np.random.default_rng(1234)
    genes_by_chrom, chrom_lens, all_genes = {}, {}, []
    for c in range(N_CHROM):
        chrom = f"chr{c + 1}"
        gs = make_genes(rng, chrom=chrom, n_genes=GENES_PER_CHROM,
                        overlap_fraction=0.15, name_prefix=f"c{c + 1}_")
        genes_by_chrom[chrom] = gs
        chrom_lens[chrom] = max(e for g in gs for _, e in g.exons) + 1000
        all_genes.extend(gs)
    gtf = "annotation.gtf"
    write_gtf(os.path.join(data_dir, gtf), all_genes)
    bams = []
    for s in range(N_SAMPLES):
        t0 = time.perf_counter()
        name = f"sample{s}.bam"
        deg = 0.0 if s % 2 == 0 else 0.3 + 0.1 * (s % 3)
        write_multichrom_bam(os.path.join(data_dir, name), genes_by_chrom,
                             chrom_lens, seed=1000 + s,
                             mean_reads_per_gene=READS_PER_GENE,
                             degradation=deg)
        print(f"[pipe] wrote {name} (deg={deg:.1f}) "
              f"in {time.perf_counter() - t0:.0f}s", file=sys.stderr,
              flush=True)
        bams.append(name)
    m = {"params": params, "gtf": gtf, "bams": bams,
         "n_genes": len(all_genes)}
    with open(manifest, "w") as f:
        json.dump(m, f)
    return m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir",
                    default=os.environ.get("PIPE_DATA_DIR", os.path.join(
                        tempfile.gettempdir(), "dn_pipeline_bench")))
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--skip-run", action="store_true")
    ap.add_argument("--nmf-iter", type=int, default=50)
    ap.add_argument("--iter", type=int, default=5)
    ap.add_argument("--jobs", type=int,
                    default=max(1, (os.cpu_count() or 2) - 1))
    args = ap.parse_args()

    m = build_dataset(args.data_dir)
    if args.skip_run:
        return
    out = args.out_dir or os.path.join(args.data_dir, "run")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "degnorm_jax",
           "--bam-files",
           *[os.path.join(args.data_dir, b) for b in m["bams"]],
           "-g", os.path.join(args.data_dir, m["gtf"]),
           "-o", out, "--nmf-iter", str(args.nmf_iter),
           "--iter", str(args.iter), "-p", str(args.jobs)]
    print("[pipe] running:", " ".join(cmd), file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=5400,
                       cwd="/root/repo")
    wall = time.perf_counter() - t0
    sys.stderr.write(r.stderr[-3000:] + "\n")
    phases = None
    mm = re.findall(r"pipeline phase timings \(s\): (\{.*\})", r.stdout)
    if mm:
        phases = mm[-1]
    reads = m["params"]["gpc"] * m["params"]["chroms"] * \
        m["params"]["rpg"] * m["params"]["samples"]
    print(json.dumps({
        "metric": "whole_pipeline_wall_s",
        "value": round(wall, 1),
        "rc": r.returncode,
        "n_genes": m["n_genes"],
        "n_samples": m["params"]["samples"],
        "approx_reads_total": reads,
        "phases": phases,
    }))
    if r.returncode != 0:
        print(r.stdout[-3000:], file=sys.stderr)


if __name__ == "__main__":
    main()
