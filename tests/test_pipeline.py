"""End-to-end pipeline tests on synthetic BAM + GTF data — the equivalent
of the reference's test_zzz_pipeline.py CLI runs, plus warm start."""
import os
import pickle

import numpy as np
import pandas as pd
import pytest

from degnorm_jax.io.simulate import make_genes, write_gtf, write_sample_bam


CHROM_LEN = 80_000


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("simdata")
    rng = np.random.default_rng(42)
    genes = make_genes(rng, n_genes=8, overlap_fraction=0.25)
    gtf = str(d / "sim.gtf")
    write_gtf(gtf, genes)
    bams = []
    for i, deg in enumerate((0.0, 0.5)):
        bam = str(d / f"sample{i}.bam")
        write_sample_bam(bam, genes, CHROM_LEN, seed=100 + i,
                         mean_reads_per_gene=120, degradation=deg)
        bams.append(bam)
    return {"gtf": gtf, "bams": bams, "genes": genes, "dir": str(d)}


def run_cli(dataset, tmp_path, extra=()):
    from degnorm_jax.cli import main
    out_base = str(tmp_path)
    # -o must already exist (reference utils.py:334-336; validated by
    # test_cli_flag_validation) — the helper creates it like a user would
    os.makedirs(out_base, exist_ok=True)
    rc = main([
        "--bam-files", *dataset["bams"],
        "-g", dataset["gtf"],
        "-o", out_base,
        "--nmf-iter", "5",
        "--iter", "2",
        *extra,
    ])
    assert rc == 0
    runs = [p for p in os.listdir(out_base) if p.startswith("degnorm_")]
    assert len(runs) == 1
    return os.path.join(out_base, runs[0])


def test_pipeline_end_to_end(dataset, tmp_path):
    out = run_cli(dataset, tmp_path)
    for fname in ("degradation_index_scores.csv", "adjusted_read_counts.csv",
                  "ran_baseline_selection.csv", "read_counts.csv",
                  "gene_exon_metadata.csv", "degnorm.log"):
        assert os.path.isfile(os.path.join(out, fname)), fname

    di = pd.read_csv(os.path.join(out, "degradation_index_scores.csv"))
    assert list(di.columns[:2]) == ["chr", "gene"]
    assert {"sample0", "sample1"} <= set(di.columns)
    vals = di[["sample0", "sample1"]].values
    assert np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 0.9).all()

    # full-pipeline numeric parity: the float64 oracle on the run's own
    # merged coverage matrices must reproduce the saved DI scores.
    from degnorm_jax.config import NMFConfig
    from degnorm_jax.oracle import nmfoa as oracle
    cov_pkl = pickle.load(open(
        os.path.join(out, "chr1", "coverage_matrices_chr1.pkl"), "rb"))
    counts_df = pd.read_csv(os.path.join(out, "read_counts.csv"))
    cov_mats = [np.asarray(cov_pkl[g], float) for g in di.gene]
    X = counts_df.set_index("gene").loc[di.gene][
        ["sample0", "sample1"]].values.astype(float)
    gold = oracle.degnorm_fit(cov_mats, X, NMFConfig(nmf_iter=5,
                                                     degnorm_iter=2))
    np.testing.assert_allclose(vals, gold.rho, rtol=1e-4, atol=1e-6)

    # coverage matrix pickles, raw + estimated
    cov_f = os.path.join(out, "chr1", "coverage_matrices_chr1.pkl")
    est_f = os.path.join(out, "chr1", "estimated_coverage_matrices_chr1.pkl")
    assert os.path.isfile(cov_f) and os.path.isfile(est_f)
    cov = pickle.load(open(cov_f, "rb"))
    est = pickle.load(open(est_f, "rb"))
    assert set(cov) == set(est) == set(di.gene)
    for g in cov:
        assert cov[g].shape == est[g].shape
        assert cov[g].shape[0] == 2

    counts = pd.read_csv(os.path.join(out, "read_counts.csv"))
    assert (counts[["sample0", "sample1"]].values.sum(axis=1) > 0).any()

    # summary report rendered
    assert os.path.isfile(os.path.join(out, "report",
                                       "degnorm_summary.html"))
    # per-iteration checkpoint written
    assert os.path.isfile(os.path.join(out, "degnorm_checkpoint.npz"))


def test_pipeline_warm_start(dataset, tmp_path):
    out1 = run_cli(dataset, tmp_path / "first")
    from degnorm_jax.cli import main
    out_base = str(tmp_path / "second")
    os.makedirs(out_base)
    rc = main(["-w", out1, "-o", out_base, "--nmf-iter", "5", "--iter", "2"])
    assert rc == 0
    runs = [p for p in os.listdir(out_base) if p.startswith("degnorm_")]
    out2 = os.path.join(out_base, runs[0])

    di1 = pd.read_csv(os.path.join(out1, "degradation_index_scores.csv"))
    di2 = pd.read_csv(os.path.join(out2, "degradation_index_scores.csv"))
    m1 = di1.set_index("gene")[["sample0", "sample1"]]
    m2 = di2.set_index("gene")[["sample0", "sample1"]]
    pd.testing.assert_frame_equal(m1.sort_index(), m2.sort_index(),
                                  check_exact=False, rtol=1e-6)


def test_pipeline_minimax_filter(dataset, tmp_path):
    out = run_cli(dataset, tmp_path, extra=("--minimax-coverage", "5"))
    di = pd.read_csv(os.path.join(out, "degradation_index_scores.csv"))
    cov = pickle.load(open(
        os.path.join(out, "chr1", "coverage_matrices_chr1.pkl"), "rb"))
    # every surviving gene clears the minimax threshold
    for g in di.gene:
        assert cov[g].max() >= 5


def test_pipeline_multichrom(tmp_path):
    """Two-chromosome dataset: per-chromosome outputs, DI matrix covers
    genes from both."""
    import numpy as np
    from degnorm_jax.io.simulate import (make_genes, write_gtf,
                                         write_multichrom_bam)
    from degnorm_jax.cli import main

    rng = np.random.default_rng(77)
    g1 = make_genes(rng, chrom="chr1", n_genes=4, name_prefix="a.")
    g2 = make_genes(rng, chrom="chr2", n_genes=3, name_prefix="b.")
    gtf = str(tmp_path / "mc.gtf")
    write_gtf(gtf, g1 + g2)
    lens = {"chr1": 60_000, "chr2": 60_000}
    bams = []
    for i in range(2):
        b = str(tmp_path / f"mcs{i}.bam")
        write_multichrom_bam(b, {"chr1": g1, "chr2": g2}, lens,
                             seed=200 + i, mean_reads_per_gene=100)
        bams.append(b)
    out_base = str(tmp_path / "out")
    os.makedirs(out_base)
    rc = main(["--bam-files", *bams, "-g", gtf, "-o", out_base,
               "--nmf-iter", "4", "--iter", "1"])
    assert rc == 0
    run = os.path.join(out_base, os.listdir(out_base)[0])
    di = pd.read_csv(os.path.join(run, "degradation_index_scores.csv"))
    assert set(di.chr) == {"chr1", "chr2"}
    assert len(di) == 7
    for c in ("chr1", "chr2"):
        assert os.path.isfile(os.path.join(
            run, c, f"coverage_matrices_{c}.pkl"))
        assert os.path.isfile(os.path.join(
            run, c, f"estimated_coverage_matrices_{c}.pkl"))


def test_pipeline_plot_genes_and_bam_dir(dataset, tmp_path):
    """--plot-genes (incl. .txt expansion) and --bam-dir scanning."""
    import shutil
    from degnorm_jax.cli import main
    bam_dir = tmp_path / "bams"
    bam_dir.mkdir()
    for b in dataset["bams"]:
        shutil.copy(b, bam_dir)
    genes_txt = tmp_path / "genes.txt"
    genes_txt.write_text("gene000\ngene001\n")
    out_base = str(tmp_path / "out")
    os.makedirs(out_base)
    rc = main(["--bam-dir", str(bam_dir), "-g", dataset["gtf"],
               "-o", out_base, "--nmf-iter", "4", "--iter", "1",
               "--plot-genes", str(genes_txt), "gene002"])
    assert rc == 0
    run = os.path.join(out_base, os.listdir(out_base)[0])
    pngs = [f for f in os.listdir(os.path.join(run, "chr1"))
            if f.endswith("_coverage.png")]
    assert any(f.lower().startswith("gene00") for f in pngs)


def test_cli_flag_validation(dataset, tmp_path):
    """Reference argparser rejections (utils.py:343-344, 398-403,
    434-436): non-positive numeric flags, --bam-dir combined with
    --bam-files, non-.bam/.cram paths, missing --bam-dir."""
    from degnorm_jax.cli import parse_config
    base = ["--bam-files", *dataset["bams"], "-g", dataset["gtf"]]
    for bad in (["-d", "0"], ["--nmf-iter", "0"], ["--iter", "-1"],
                ["-d", "-3"]):
        with pytest.raises(SystemExit):
            parse_config(base + bad)
    with pytest.raises(SystemExit):
        parse_config(base + ["--bam-dir", dataset["dir"]])
    with pytest.raises(SystemExit):
        parse_config(["--bam-files", "reads.txt", dataset["bams"][0],
                      "-g", dataset["gtf"]])
    with pytest.raises(SystemExit):
        parse_config(["--bam-dir", str(tmp_path / "nope"),
                      "-g", dataset["gtf"]])
    # duplicate .bam names (utils.py:478-480)
    with pytest.raises(SystemExit):
        parse_config(["--bam-files", dataset["bams"][0], dataset["bams"][0],
                      "-g", dataset["gtf"]])
    # .bai validation (utils.py:443-457): count mismatch, extension, missing
    with pytest.raises(SystemExit):
        parse_config(base + ["--bai-files", "one.bai"])
    with pytest.raises(SystemExit):
        parse_config(base + ["--bai-files", "a.txt", "b.txt"])
    with pytest.raises(SystemExit):
        parse_config(base + ["--bai-files", str(tmp_path / "a.bai"),
                             str(tmp_path / "b.bai")])
    # output dir must exist (utils.py:334-336)
    with pytest.raises(SystemExit):
        parse_config(base + ["-o", str(tmp_path / "no_such_dir")])
    # warm-start dir must exist (utils.py:367-369)
    with pytest.raises(SystemExit):
        parse_config(["-w", str(tmp_path / "no_warm")])
    # warm start ignores simultaneously-supplied inputs (utils.py:370-379)
    cfg = parse_config(base + ["-w", dataset["dir"]])
    assert cfg.warm_start_dir and not cfg.bam_files
    assert cfg.genome_annotation is None
    # the valid base still parses
    cfg = parse_config(base)
    assert len(cfg.bam_files) == 2


def test_multihost_init_noop(monkeypatch):
    """initialize_multihost is a no-op without coordinator config."""
    from degnorm_jax.parallel.distributed import initialize_multihost
    monkeypatch.delenv("DEGNORM_JAX_COORDINATOR", raising=False)
    monkeypatch.delenv("DEGNORM_JAX_NUM_PROCESSES", raising=False)
    initialize_multihost()   # must not raise or initialize anything


def test_pipeline_stream_etl_matches(dataset, tmp_path):
    """--stream-etl on: auto-builds missing .bai indexes and produces DI
    scores identical to the whole-file decode path."""
    import shutil
    d = tmp_path / "stream_bams"
    d.mkdir()
    bams = []
    for b in dataset["bams"]:
        shutil.copy(b, d)
        bams.append(str(d / os.path.basename(b)))
    ds = dict(dataset, bams=bams)
    out_on = run_cli(ds, tmp_path / "on", extra=("--stream-etl", "on"))
    # indexes were created natively next to the BAMs
    assert all(os.path.isfile(b + ".bai") for b in bams)
    out_off = run_cli(ds, tmp_path / "off", extra=("--stream-etl", "off"))
    a = pd.read_csv(os.path.join(out_on, "degradation_index_scores.csv"))
    b = pd.read_csv(os.path.join(out_off, "degradation_index_scores.csv"))
    pd.testing.assert_frame_equal(a, b)


def test_resume_is_pure_artifact_load(dataset, tmp_path):
    """When every per-(sample, chrom) artifact already exists, the mid-ETL
    resume path (reference reads.py:368-386) must not decode the .bam at
    all — coverage_read_counts becomes a pure artifact load.  This is also
    the multihost peer-shard handoff path (run.py _cold_start)."""
    from degnorm_jax.io.gtf import process_annotation
    from degnorm_jax.io.overlap import overlap_structure
    from degnorm_jax.pipeline.sample import BamSampleProcessor

    exon_df = process_annotation(dataset["gtf"])
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = {c: overlap_structure(gene_df[gene_df.chr == c])
          for c in exon_df.chr.unique()}

    out = str(tmp_path / "etl")
    s = BamSampleProcessor(dataset["bams"][0], output_dir=out, stream=False)
    first = s.coverage_read_counts(ov, gene_df, exon_df)

    s2 = BamSampleProcessor(dataset["bams"][0], output_dir=out, stream=False)
    s2._load_all = None          # any decode attempt would raise TypeError
    second = s2.coverage_read_counts(ov, gene_df, exon_df)

    assert set(first) == set(second)
    for chrom in first:
        a, b = first[chrom], second[chrom]
        assert a.read_counts == b.read_counts
        np.testing.assert_array_equal(
            np.asarray(a.isolated_coverage, dtype=float),
            np.asarray(b.isolated_coverage, dtype=float))
        assert set(a.overlap_coverage) == set(b.overlap_coverage)
        for g in a.overlap_coverage:
            np.testing.assert_array_equal(a.overlap_coverage[g],
                                          b.overlap_coverage[g])
