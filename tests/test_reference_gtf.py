"""Parity on the reference's real bundled GTF (chr1 subset, 141 exon rows)
— the annotation half of its end-to-end test workload (BASELINE config 1;
the BAM blobs are stripped from the snapshot, so reads are synthesized
over the real exon structure)."""
import os

import numpy as np
import pandas as pd
import pytest

from degnorm_jax.io.gtf import load_exons, process_annotation
from degnorm_jax.io.overlap import overlap_structure
from tests.test_coverage_parity import _stub_modules

REF_GTF = "/root/reference/degnorm/tests/data/chr1_small.gtf"

pytestmark = pytest.mark.skipif(not os.path.isfile(REF_GTF),
                                reason="reference GTF unavailable")


def test_gtf_loader_matches_reference():
    _stub_modules()
    from degnorm.loaders import GeneAnnotationLoader
    ref = GeneAnnotationLoader(REF_GTF).get_data()
    mine = load_exons(REF_GTF)
    pd.testing.assert_frame_equal(
        mine.sort_values(["chr", "start", "end", "gene"]).reset_index(drop=True),
        ref.sort_values(["chr", "start", "end", "gene"]).reset_index(drop=True))


def test_annotation_pipeline_matches_reference():
    _stub_modules()
    from degnorm.gene_processing import (GeneAnnotationProcessor,
                                         get_gene_overlap_structure)
    ref_exons = GeneAnnotationProcessor(REF_GTF, verbose=False).run()
    mine = process_annotation(REF_GTF)
    cols = ["chr", "gene", "start", "end", "gene_start", "gene_end"]
    pd.testing.assert_frame_equal(
        mine[cols].sort_values(cols).reset_index(drop=True),
        ref_exons[cols].sort_values(cols).reset_index(drop=True))

    gene_df = mine[["chr", "gene", "gene_start", "gene_end"]
                   ].drop_duplicates().reset_index(drop=True)
    ref_overlap = get_gene_overlap_structure(gene_df)
    my_overlap = overlap_structure(gene_df)
    assert (sorted(my_overlap["isolated_genes"])
            == sorted(ref_overlap["isolated_genes"]))
    assert (sorted(map(sorted, my_overlap["overlap_genes"]))
            == sorted(map(sorted, ref_overlap["overlap_genes"])))


def test_pipeline_on_reference_annotation(tmp_path):
    """End-to-end run with the real annotation + synthetic reads over its
    exon structure, full-pipeline DI parity vs the float64 oracle."""
    import pickle
    from degnorm_jax.cli import main
    from degnorm_jax.config import NMFConfig
    from degnorm_jax.io.simulate import SimGene, simulate_sample
    from degnorm_jax.io import bam as bamio
    from degnorm_jax.oracle import nmfoa as oracle

    exon_df = load_exons(REF_GTF)
    genes = [SimGene(g, "chr1",
                     [(int(r.start), int(r.end))
                      for r in exon_df[exon_df.gene == g].itertuples()])
             for g in exon_df.gene.unique()]
    chrom_len = int(exon_df.end.max()) + 10_000
    bams = []
    for i in range(2):
        rng = np.random.default_rng(300 + i)
        recs = simulate_sample(rng, genes, chrom_len,
                               mean_reads_per_gene=80,
                               degradation=0.4 * i)
        b = str(tmp_path / f"ref_s{i}.bam")
        bamio.write_bam(b, ["chr1"], [chrom_len], recs)
        bams.append(b)

    out_base = str(tmp_path / "out")
    os.makedirs(out_base)
    rc = main(["--bam-files", *bams, "-g", REF_GTF, "-o", out_base,
               "--nmf-iter", "5", "--iter", "2"])
    assert rc == 0
    run = os.path.join(out_base, os.listdir(out_base)[0])
    di = pd.read_csv(os.path.join(run, "degradation_index_scores.csv"))
    assert len(di) >= 3          # several real genes produce coverage

    cov_pkl = pickle.load(open(
        os.path.join(run, "chr1", "coverage_matrices_chr1.pkl"), "rb"))
    counts = pd.read_csv(os.path.join(run, "read_counts.csv"))
    sample_cols = counts.columns.tolist()[2:]
    X = counts.set_index("gene").loc[di.gene][sample_cols].values.astype(float)
    cov_mats = [np.asarray(cov_pkl[g], float) for g in di.gene]
    gold = oracle.degnorm_fit(cov_mats, X,
                              NMFConfig(nmf_iter=5, degnorm_iter=2))
    # f32 production path vs f64 oracle: the documented precision class is
    # atol 5e-3 (test_engine_f32_tolerance / PARITY.md §5)
    np.testing.assert_allclose(di[sample_cols].values, gold.rho,
                               rtol=0, atol=5e-3)
