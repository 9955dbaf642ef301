"""Two-process jax.distributed smoke test — the degnorm_mpi replacement
running as two real OS processes on CPU (the reference tests its MPI path
the same way: 2 ranks on one machine, SURVEY.md §4)."""
import os
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from degnorm_jax.parallel.distributed import initialize_multihost, global_mesh
initialize_multihost()
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()

import numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = global_mesh()

# gene-sharded global reduction across both processes (the outer-loop
# column-sum pattern): every process contributes its shard, psum crosses
# process boundaries.
n, p = 8, 3
x = np.arange(n * p, dtype=np.float32).reshape(n, p)
xs = jax.make_array_from_callback(
    (n, p), NamedSharding(mesh, P("genes", None)),
    lambda idx: x[idx])
col = jax.jit(lambda a: jnp.sum(a, axis=0),
              out_shardings=NamedSharding(mesh, P()))(xs)
np.testing.assert_allclose(np.asarray(col), x.sum(axis=0))
print(f"proc {{jax.process_index()}} OK", flush=True)
"""


def test_two_process_distributed(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo))
    env = dict(os.environ,
               DEGNORM_JAX_COORDINATOR="localhost:19731",
               DEGNORM_JAX_NUM_PROCESSES="2")
    procs = []
    for pid in range(2):
        e = dict(env, DEGNORM_JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=100)
        outs.append(out)
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert "OK" in out


_ENGINE_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_ENABLE_X64"] = "1"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from degnorm_jax.parallel.distributed import initialize_multihost, global_mesh
initialize_multihost()

import numpy as np
from collections import OrderedDict
from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.engine import DegNormEngine

rng = np.random.default_rng(91)
cov = OrderedDict()
for i in range(8):
    L = int(120 + 40 * i)
    t = np.linspace(0, 1, L)
    base = (np.abs(np.sin(np.pi * t)) + 0.2) * (3 + i)
    cov[f"g{{i}}"] = np.round(np.vstack([base * (0.5 + 0.3 * j)
                                         for j in range(3)]), 3)
X = np.round(np.abs(rng.standard_normal((8, 3))) * 200 + 20)

eng = DegNormEngine(
    NMFConfig(nmf_iter=5, degnorm_iter=2),
    EngineConfig(rank1_method="power", dtype="float64",
                 bucket_widths=(512,)),
    mesh=global_mesh())
res = eng.run(cov, X)
np.save({out!r} + f"/rho_{{jax.process_index()}}.npy", res.rho)
print("ENGINE OK", flush=True)
"""


_CLI_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from degnorm_jax.cli import main
rc = main(["--bam-files", *{bams!r}, "-g", {gtf!r}, "-o", {out!r},
           "--nmf-iter", "4", "--iter", "1", "--multihost",
           "--plot-genes", "gene000", "gene001"])
assert rc == 0
# post-run collective sanity: the output-dir broadcast primitive
# round-trips arbitrary unicode from the coordinator
from degnorm_jax.parallel.distributed import broadcast_string, is_coordinator
got = broadcast_string("dir/å-π ok" if is_coordinator() else "")
assert got == "dir/å-π ok", got
print("CLI OK", flush=True)
"""


def test_two_process_cli_multihost(tmp_path):
    """Full CLI run with --multihost across two OS processes: the
    coordinator owns the single run directory (its timestamped name is
    broadcast), workers write no duplicate artifacts, and the DI output
    matches a single-process run of the same data (the reference's MPI
    entry point contract, __main_mpi__.py:62-71)."""
    import numpy as np
    import pandas as pd
    from degnorm_jax.io.simulate import make_genes, write_gtf, \
        write_sample_bam

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(17)
    genes = make_genes(rng, n_genes=6, overlap_fraction=0.25)
    gtf = str(tmp_path / "sim.gtf")
    write_gtf(gtf, genes)
    bams = []
    for i, deg in enumerate((0.0, 0.5)):
        bam = str(tmp_path / f"mh{i}.bam")
        write_sample_bam(bam, genes, 80_000, seed=400 + i,
                         mean_reads_per_gene=100, degradation=deg)
        bams.append(bam)

    out_base = tmp_path / "mh_out"
    out_base.mkdir()
    script = tmp_path / "cli_worker.py"
    script.write_text(_CLI_WORKER.format(repo=repo, bams=bams, gtf=gtf,
                                         out=str(out_base)))
    env = dict(os.environ,
               DEGNORM_JAX_COORDINATOR="localhost:19751",
               DEGNORM_JAX_NUM_PROCESSES="2")
    procs = []
    for pid in range(2):
        e = dict(env, DEGNORM_JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pid, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=300)
        assert pr.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "CLI OK" in out
        outs.append(out)

    # exactly ONE run directory — both processes agreed on the broadcast
    # name instead of racing create_output_dir
    runs = [p for p in os.listdir(out_base) if p.startswith("degnorm_")]
    assert len(runs) == 1, runs
    run = os.path.join(out_base, runs[0])
    # shared ETL scratch cleaned up; no duplicate output tree
    assert not [p for p in os.listdir(run) if p.startswith(".etl")]
    # the ETL was SPLIT across processes (the reference scatters .bam
    # files over ranks, __main_mpi__.py:236-262): each process decoded
    # only its own sample and loaded the peer's from the shared scratch
    for pid, mine, theirs in ((0, "mh0", "mh1"), (1, "mh1", "mh0")):
        assert (f"multihost ETL: this process owns 1/2 sample(s): {mine}"
                in outs[pid]), outs[pid][-3000:]
        assert (f"SAMPLE {mine}: computing coverage/read counts"
                in outs[pid])
        assert (f"SAMPLE {theirs}: computing coverage/read counts"
                not in outs[pid])
        assert (f"SAMPLE {theirs}: loading peer shard" in outs[pid])
    # degnorm_checkpoint.npz: the device-resident outer loop gathers its
    # state per iteration (collective) and the coordinator writes it
    for fname in ("degradation_index_scores.csv", "adjusted_read_counts.csv",
                  "read_counts.csv", "degnorm_checkpoint.npz", "degnorm.log"):
        assert os.path.isfile(os.path.join(run, fname)), fname
    # --plot-genes is scattered across processes (round-robin over the
    # sorted case-insensitive intersection — the reference's plot scatter,
    # __main_mpi__.py:461-488): the requested lowercase names resolve to
    # the canonical GENE00x, proc0 plots GENE000 and proc1 GENE001
    pngs = {f for f in os.listdir(os.path.join(run, "chr1"))
            if f.endswith("_coverage.png")}
    assert {"GENE000_coverage.png", "GENE001_coverage.png"} <= pngs, pngs
    # (fitted gene names are lowercase; CoverageLoader upper-cases names
    # for the plot files, like the reference's data_access.py:49)
    assert "plotting coverage for 1 gene(s): gene000" in outs[0], outs[0][-2000:]
    assert "plotting coverage for 1 gene(s): gene001" in outs[1], outs[1][-2000:]

    # DI parity vs a single-process run of the identical data
    from degnorm_jax.cli import main
    solo_base = tmp_path / "solo_out"
    solo_base.mkdir()
    rc = main(["--bam-files", *bams, "-g", gtf, "-o", str(solo_base),
               "--nmf-iter", "4", "--iter", "1"])
    assert rc == 0
    solo = os.path.join(solo_base, os.listdir(str(solo_base))[0])
    di_mh = pd.read_csv(os.path.join(run, "degradation_index_scores.csv"))
    di_solo = pd.read_csv(os.path.join(solo,
                                       "degradation_index_scores.csv"))
    m1 = di_mh.set_index("gene")[["mh0", "mh1"]].sort_index()
    m2 = di_solo.set_index("gene")[["mh0", "mh1"]].sort_index()
    np.testing.assert_allclose(m1.values, m2.values, rtol=1e-4, atol=1e-6)


def test_shard_plot_genes():
    """The plot-gene scatter is deterministic, case-insensitive, disjoint,
    and covering (reference scatter semantics, __main_mpi__.py:461-488 +
    case-insensitive gene lookup, data_access.py:61-63)."""
    from degnorm_jax.pipeline.run import _shard_plot_genes

    fitted = ["GENE2", "GENE0", "GENE1", "OTHER"]
    req = ["gene1", "Gene0", "GENE2", "missing", "gene1"]
    # single process: all matches, sorted, canonical casing, deduped
    assert _shard_plot_genes(req, fitted) == ["GENE0", "GENE1", "GENE2"]
    # two processes: disjoint round-robin cover
    s0 = _shard_plot_genes(req, fitted, 0, 2)
    s1 = _shard_plot_genes(req, fitted, 1, 2)
    assert s0 == ["GENE0", "GENE2"] and s1 == ["GENE1"]
    # no match -> empty shard everywhere
    assert _shard_plot_genes(["nope"], fitted, 0, 2) == []


def test_two_process_engine(tmp_path):
    """Full DegNormEngine fit with the gene mesh spanning two OS processes
    (device-resident outer loop) — results must match a single-process
    float64 run exactly."""
    import numpy as np
    from collections import OrderedDict
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "engine_worker.py"
    script.write_text(_ENGINE_WORKER.format(repo=repo, out=str(tmp_path)))
    env = dict(os.environ,
               DEGNORM_JAX_COORDINATOR="localhost:19741",
               DEGNORM_JAX_NUM_PROCESSES="2")
    procs = []
    for pid in range(2):
        e = dict(env, DEGNORM_JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for pid, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=180)
        assert pr.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "ENGINE OK" in out

    # single-process reference run with identical data
    rng = np.random.default_rng(91)
    cov = OrderedDict()
    for i in range(8):
        L = int(120 + 40 * i)
        t = np.linspace(0, 1, L)
        base = (np.abs(np.sin(np.pi * t)) + 0.2) * (3 + i)
        cov[f"g{i}"] = np.round(np.vstack([base * (0.5 + 0.3 * j)
                                           for j in range(3)]), 3)
    X = np.round(np.abs(rng.standard_normal((8, 3))) * 200 + 20)
    single = DegNormEngine(
        NMFConfig(nmf_iter=5, degnorm_iter=2),
        EngineConfig(rank1_method="power", dtype="float64",
                     bucket_widths=(512,))).run(cov, X)

    for pid in range(2):
        rho = np.load(tmp_path / f"rho_{pid}.npy")
        np.testing.assert_allclose(rho, single.rho, rtol=1e-10)
