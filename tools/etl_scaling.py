"""Measure multihost ETL scaling: sample-sharded cold-start decode across
2 OS processes vs a single process on the same data.

The reference's only multi-node performance claim is qualitative —
"preprocessing and coverage matrix approximations will scale by the number
of available compute nodes" (reference docs/howtos/speedups.md:5-9).  This
tool measures that claim for the sample-sharded ETL (pipeline/run.py
``_cold_start``): each process decodes its round-robin share of the BAMs
into the shared scratch, then loads the peers' artifacts after a barrier.

Run from the repo root on an idle host:

    python tools/etl_scaling.py [n_samples] [reads_per_sample]

Prints per-phase wall times and the 2-process scaling efficiency
(solo_decode / (2 * max_proc_decode)).  CPU-only; no accelerator needed.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SAMPLES = int(sys.argv[1]) if len(sys.argv) > 1 else 4
N_READS = int(sys.argv[2]) if len(sys.argv) > 2 else 400_000

_WORKER = r"""
import os, sys, time, json
# pin this emulated "node" to its disjoint CPU set: the native BGZF
# reader threads internally, so without pinning a single process already
# saturates the whole host and 2-process runs measure core contention,
# not node scaling
cpus = os.environ.get("DEGNORM_AFFINITY")
if cpus:
    os.sched_setaffinity(0, {{int(c) for c in cpus.split(",")}})
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from degnorm_jax.parallel.distributed import initialize_multihost, global_mesh
initialize_multihost()
from degnorm_jax.config import PipelineConfig
from degnorm_jax.pipeline.run import _cold_start

cfg = PipelineConfig(bam_files=tuple({bams!r}), bai_files=(),
                     genome_annotation={gtf!r}, output_dir={out!r},
                     n_jobs=1)
os.makedirs({out!r}, exist_ok=True)
t0 = time.time()
_cold_start(cfg, {out!r}, write_outputs=(jax.process_index() == 0),
            mesh=global_mesh())
print(json.dumps({{"proc": jax.process_index(),
                   "etl_s": round(time.time() - t0, 2)}}), flush=True)
"""


def main():
    import numpy as np
    from degnorm_jax.io.simulate import make_genes, write_gtf, write_sample_bam

    # ETL_SCALING_DIR: reuse an existing generated dataset (the 20M-read
    # config takes ~28 min to synthesize)
    d = os.environ.get("ETL_SCALING_DIR") or ""
    if d and all(os.path.isfile(os.path.join(d, f"s{i}.bam"))
                 for i in range(N_SAMPLES)):
        gtf = os.path.join(d, "sim.gtf")
        bams = [os.path.join(d, f"s{i}.bam") for i in range(N_SAMPLES)]
        print(f"[synth] reusing {d}", file=sys.stderr)
        # fresh output dirs inside the cached dataset dir
        import shutil
        for sub in ("solo", "mh"):
            shutil.rmtree(os.path.join(d, sub), ignore_errors=True)
    else:
        d = tempfile.mkdtemp(prefix="etl_scaling_")
        rng = np.random.default_rng(11)
        genes = make_genes(rng, n_genes=200, overlap_fraction=0.1)
        gtf = os.path.join(d, "sim.gtf")
        write_gtf(gtf, genes)
        chrom_len = max(e for g in genes for _, e in g.exons) + 10_000
        bams = []
        t0 = time.time()
        for i in range(N_SAMPLES):
            b = os.path.join(d, f"s{i}.bam")
            write_sample_bam(b, genes, chrom_len, seed=500 + i,
                             mean_reads_per_gene=N_READS // len(genes),
                             degradation=0.3 * (i % 3))
            bams.append(b)
        print(f"[synth] {N_SAMPLES} x {N_READS} reads: {time.time()-t0:.1f}s",
              file=sys.stderr)

    # Emulated node = half this host's cores, pinned (the native reader
    # threads internally; without pinning one process saturates the host
    # and "2 nodes" would just measure core contention).
    n_cpu = os.cpu_count() or 4
    half = max(1, n_cpu // 2)
    node0 = ",".join(str(c) for c in range(half))
    node1 = ",".join(str(c) for c in range(half, 2 * half))

    # --- single process on ONE emulated node ---
    from degnorm_jax.config import PipelineConfig
    from degnorm_jax.pipeline.run import _cold_start
    solo_out = os.path.join(d, "solo")
    os.makedirs(solo_out)
    os.sched_setaffinity(0, {int(c) for c in node0.split(",")})
    cfg = PipelineConfig(bam_files=tuple(bams), bai_files=(),
                         genome_annotation=gtf, output_dir=solo_out, n_jobs=1)
    t0 = time.time()
    _cold_start(cfg, solo_out)
    solo_s = time.time() - t0
    os.sched_setaffinity(0, range(n_cpu))
    print(f"[solo] 1 node ({half} cores): {solo_s:.2f}s", file=sys.stderr)

    # --- two processes, one emulated node each ---
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mh_out = os.path.join(d, "mh")
    script = os.path.join(d, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER.format(repo=repo, bams=bams, gtf=gtf, out=mh_out))
    env = dict(os.environ, DEGNORM_JAX_COORDINATOR="localhost:19881",
               DEGNORM_JAX_NUM_PROCESSES="2")
    procs = []
    for pid, aff in ((0, node0), (1, node1)):
        e = dict(env, DEGNORM_JAX_PROCESS_ID=str(pid),
                 DEGNORM_AFFINITY=aff)
        procs.append(subprocess.Popen([sys.executable, script], env=e,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    times = {}
    for pid, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=1800)
        assert pr.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        rec = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        times[rec["proc"]] = rec["etl_s"]
    mh_s = max(times.values())
    print(f"[multihost] 2 processes, 1 thread each: "
          f"{times} -> wall {mh_s:.2f}s", file=sys.stderr)
    print(json.dumps({
        "solo_etl_s": round(solo_s, 2), "mh2_etl_s": round(mh_s, 2),
        "speedup": round(solo_s / mh_s, 2),
        "scaling_efficiency": round(solo_s / (2 * mh_s), 3)}))


if __name__ == "__main__":
    main()
