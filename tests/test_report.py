"""Post-hoc data access, visualization, and report rendering tests —
mirrors the reference's fake-output-dir fixture strategy
(tests/test_data_access.py:17-107)."""
import os
import pickle

import numpy as np
import pandas as pd
import pytest

from degnorm_jax.report.data_access import (CoverageLoader, get_coverage_data,
                                            get_coverage_plots)
from degnorm_jax.report.report import render_report
from degnorm_jax.report.visualizations import (get_di_boxplots,
                                               get_di_correlation,
                                               get_di_heatmap,
                                               load_di_scores, union_exons)

SAMPLES = ["s1", "s2", "s3"]


@pytest.fixture(scope="module")
def fake_run_dir(tmp_path_factory):
    """Dummy DegNorm output dir with random coverage pickles."""
    d = tmp_path_factory.mktemp("fakeout")
    rng = np.random.default_rng(0)
    genes = [("chr1", "GENEA", 1000, 2200), ("chr1", "GENEB", 5000, 5800),
             ("chr2", "GENEC", 100, 900)]
    exon_rows, cov, est = [], {}, {}
    for chrom, g, s, e in genes:
        mid = (s + e) // 2
        exon_rows += [(chrom, g, s, mid - 50, s, e),
                      (chrom, g, mid + 50, e, s, e)]
        L = (mid - 50 - s + 1) + (e - mid - 50 + 1)
        raw = rng.negative_binomial(20, 0.5, size=(len(SAMPLES), L)).astype(float)
        cov.setdefault(chrom, {})[g] = raw
        est.setdefault(chrom, {})[g] = raw + rng.random(raw.shape)
    exon_df = pd.DataFrame(exon_rows, columns=[
        "chr", "gene", "start", "end", "gene_start", "gene_end"])
    exon_df.to_csv(d / "gene_exon_metadata.csv", index=False)

    names = [g for _, g, _, _ in genes]
    chroms = [c for c, _, _, _ in genes]
    rho = np.clip(rng.random((3, 3)) * 0.8, 0, 0.9)
    counts = rng.integers(10, 500, (3, 3))
    for fname, mat in (("degradation_index_scores.csv", rho),
                       ("read_counts.csv", counts),
                       ("adjusted_read_counts.csv", counts * 1.1)):
        df = pd.DataFrame(mat, columns=SAMPLES)
        df.insert(0, "gene", names)
        df.insert(0, "chr", chroms)
        df.to_csv(d / fname, index=False)

    for chrom in cov:
        os.makedirs(d / chrom, exist_ok=True)
        with open(d / chrom / f"coverage_matrices_{chrom}.pkl", "wb") as f:
            pickle.dump(cov[chrom], f)
        with open(d / chrom / f"estimated_coverage_matrices_{chrom}.pkl",
                  "wb") as f:
            pickle.dump(est[chrom], f)
    return str(d)


def test_union_exons():
    x = np.array([[14563, 14600], [14590, 14640], [15000, 15100]])
    out = union_exons(x)
    np.testing.assert_array_equal(out, [[14563, 14640], [15000, 15100]])


def test_coverage_loader_case_insensitive(fake_run_dir):
    ldr = CoverageLoader(fake_run_dir).load(["genea", "GeneC"])
    assert set(ldr.cov_dict) == {"GENEA", "GENEC"}
    assert ldr.sample_ids == SAMPLES


def test_coverage_loader_missing_gene(fake_run_dir):
    with pytest.raises(ValueError):
        CoverageLoader(fake_run_dir).load(["NOPE"])


def test_get_coverage_data_save(fake_run_dir, tmp_path):
    out = get_coverage_data(["GENEA"], fake_run_dir, save_dir=str(tmp_path))
    assert "GENEA" in out
    assert out["GENEA"]["raw"].columns.tolist() == SAMPLES
    assert os.path.isfile(tmp_path / "chr1" / "GENEA_raw_coverage.txt")
    assert os.path.isfile(tmp_path / "chr1" / "GENEA_estimated_coverage.txt")


def test_get_coverage_plots_save(fake_run_dir, tmp_path):
    paths = get_coverage_plots("all", fake_run_dir, save_dir=str(tmp_path))
    assert len(paths) == 3
    for p in paths:
        assert os.path.isfile(p) and p.endswith("_coverage.png")


def test_di_plots(fake_run_dir, tmp_path):
    df = load_di_scores(fake_run_dir)
    assert df.shape == (3, 3)
    for fn in (get_di_heatmap, get_di_correlation, get_di_boxplots):
        p = fn(fake_run_dir, save_dir=str(tmp_path))
        assert os.path.isfile(p)


def test_render_report(fake_run_dir):
    rho = pd.read_csv(os.path.join(
        fake_run_dir, "degradation_index_scores.csv"))[SAMPLES].values
    path = render_report(
        data_dir=fake_run_dir,
        degnorm_data={"degnorm_iter": 5, "nmf_iter": 100,
                      "downsample_rate": 1, "rho": rho,
                      "genes": ["GENEA", "GENEB", "GENEC"]},
        bam_files=["a.bam", "b.bam", "c.bam"], sample_ids=SAMPLES,
        output_dir=fake_run_dir)
    assert os.path.isfile(path)
    html = open(os.path.join(fake_run_dir, "report",
                             "degnorm_summary.html")).read()
    assert "DegNorm-JAX pipeline summary" in html
