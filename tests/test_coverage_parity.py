"""ETL parity: my vectorized coverage builder vs the reference's actual
`chromosome_coverage_read_counts`, run in-process with its BAM loader
monkeypatched (pysam is unavailable; the reference code itself is imported
read-only and fed the same synthetic reads).
"""
import os
import pickle
import sys
import types

import numpy as np
import pandas as pd
import pytest

from degnorm_jax.io import bam as bamio
from degnorm_jax.io.coverage import chromosome_coverage_read_counts
from degnorm_jax.io.overlap import overlap_structure

CHROM = "chr1"
CHROM_LEN = 50_000


class _StubInterval:
    def __init__(self, chrom, start, end, strand="."):
        self.chrom, self.start, self.end = chrom, start, end


class _StubGAS:
    """Minimal per-base GenomicArrayOfSets: just enough for the reference's
    get_gene_overlap_structure (gene_processing.py:167-194)."""

    def __init__(self, chroms, stranded=False):
        self.base = {}

    class _View:
        def __init__(self, gas, iv):
            self.gas, self.iv = gas, iv

        def __iadd__(self, value):
            for p in range(self.iv.start, self.iv.end):
                self.gas.base.setdefault(p, set()).add(value)
            return self

        def steps(self):
            run_set, run_start = None, None
            for p in range(self.iv.start, self.iv.end + 1):
                s = frozenset(self.gas.base.get(p, set()))
                if p == self.iv.end or s != run_set:
                    if run_set is not None:
                        yield ((run_start, p), set(run_set))
                    run_set, run_start = s, p

    def __getitem__(self, iv):
        return self._View(self, iv)

    def __setitem__(self, iv, view):
        pass   # supports the `gas[iv] += x` statement form


def _stub_modules():
    if "pkg_resources" not in sys.modules:
        stub = types.ModuleType("pkg_resources")
        stub.resource_filename = lambda *a, **k: "/dev/null"
        sys.modules["pkg_resources"] = stub
    if "pysam" not in sys.modules:
        ps = types.ModuleType("pysam")
        ps.AlignmentFile = object
        sys.modules["pysam"] = ps
    if "HTSeq" not in sys.modules:
        ht = types.ModuleType("HTSeq")
        ht.GenomicArrayOfSets = _StubGAS
        ht.GenomicInterval = _StubInterval
        sys.modules["HTSeq"] = ht
    import networkx as nx
    if not hasattr(nx, "from_numpy_matrix"):
        nx.from_numpy_matrix = nx.from_numpy_array  # networkx>=3 rename
    if not hasattr(np, "float_"):
        np.float_ = np.float64  # numpy>=2 removal (reference uses np.float_)
    if "/root/reference" not in sys.path:
        sys.path.append("/root/reference")


@pytest.fixture(scope="module")
def annotation():
    """Synthetic annotation: two overlapping genes + two isolated genes."""
    exon_rows = [
        # gene A: two exons
        (CHROM, 1001, 1400, "geneA"),
        (CHROM, 1801, 2200, "geneA"),
        # gene B overlaps A's second exon region
        (CHROM, 2001, 2600, "geneB"),
        (CHROM, 3001, 3300, "geneB"),
        # isolated gene C
        (CHROM, 10001, 10800, "geneC"),
        (CHROM, 11201, 11600, "geneC"),
        # isolated gene D (single exon)
        (CHROM, 20001, 21000, "geneD"),
    ]
    exon_df = pd.DataFrame(exon_rows, columns=["chr", "start", "end", "gene"])
    gene_df = exon_df.groupby(["chr", "gene"], as_index=False).agg(
        gene_start=("start", "min"), gene_end=("end", "max"))
    exon_df = exon_df.merge(gene_df, on=["chr", "gene"])
    return gene_df, exon_df


def synth_reads(rng, gene_df, exon_df, n=400, paired=False):
    """Random reads: mostly exonic, some intron-crossing, some off-gene,
    some multimapped (NH=2). Returns reference-style row tuples."""
    rows = []
    exons = exon_df[["start", "end"]].values
    for i in range(n):
        r = rng.random()
        if r < 0.75:
            # fully inside one exon (maybe spliced across two)
            ei = rng.integers(0, len(exons))
            s0, e0 = exons[ei][0] - 1, exons[ei][1] - 1
            if e0 - s0 < 60:
                continue
            pos = int(rng.integers(s0, e0 - 50))
            cigar = "50M"
        elif r < 0.85:
            # spliced read across geneC's intron
            pos = int(rng.integers(10700, 10750))
            gap = 11200 - (pos + 25)
            cigar = f"25M{gap}N25M"
        else:
            # intronic/intergenic read — should be dropped
            pos = int(rng.integers(4000, 9000))
            cigar = "50M"
        nh = 2 if rng.random() < 0.05 else 1
        if paired:
            mpos = pos + int(rng.integers(20, 120))
            rows.append((f"SRR.{i}.1", pos, cigar, nh, 0))
            rows.append((f"SRR.{i}.2", mpos, "50M", nh, 0))
        else:
            rows.append((f"SRR.{i}", pos, cigar, nh, -1))
    return rows


def run_reference(tmp_path, rows, gene_df, exon_df, paired,
                  chrom_len=CHROM_LEN, sample_id="s1", save_dir=None):
    """Drive the reference implementation on the same synthetic reads."""
    _stub_modules()
    from degnorm.reads import BamReadsProcessor
    from degnorm.gene_processing import get_gene_overlap_structure

    proc = BamReadsProcessor.__new__(BamReadsProcessor)
    proc.verbose = False
    proc.sample_id = sample_id
    proc.save_dir = save_dir or str(tmp_path / "ref_out")
    os.makedirs(proc.save_dir, exist_ok=True)
    proc.paired = paired
    proc.header = pd.DataFrame({"chr": [CHROM], "length": [chrom_len]})

    # reference filter semantics from load_chromosome_reads (reads.py:225-259)
    recs = [(q, p, c) for (q, p, c, nh, rnext) in rows
            if nh <= 1 and (not paired or rnext != -1)]
    df = pd.DataFrame(recs, columns=["qname", "pos", "cigar"])
    df["pos"] = df["pos"].astype(int)
    if paired:
        df["qname_unpaired"] = df.qname.apply(
            lambda x: ".".join(x.split(".")[:-1]))
        # kind="stable": pin the mate-role tie-break to file order.  The
        # reference's own unstable quicksort permutes tied mates in a way
        # that depends on the pandas string backend (this test flipped
        # pass/fail with `future.infer_string` before pinning) — see
        # refstub.pin_paired_tiebreak and PARITY.md §known deviations 4b.
        df = df.sort_values("qname_unpaired", kind="stable")
    proc.load_chromosome_reads = lambda chrom: df.copy()

    overlap_dat = get_gene_overlap_structure(gene_df)
    proc.chromosome_coverage_read_counts(
        gene_overlap_dat=overlap_dat,
        chrom_gene_df=gene_df.copy(),
        chrom_exon_df=exon_df.copy(),
        chrom=CHROM)

    out = {}
    from scipy import sparse
    cov_f = os.path.join(proc.save_dir,
                         f"chrom_coverage_{sample_id}_{CHROM}.npz")
    out["iso"] = (np.asarray(sparse.load_npz(cov_f).todense()).ravel()
                  if os.path.isfile(cov_f) else None)
    ol_f = os.path.join(proc.save_dir,
                        f"overlap_coverage_{sample_id}_{CHROM}.pkl")
    out["overlap"] = pickle.load(open(ol_f, "rb")) if os.path.isfile(ol_f) \
        else {}
    cnt = pd.read_csv(os.path.join(proc.save_dir,
                                   f"read_counts_{sample_id}_{CHROM}.csv"))
    out["counts"] = dict(zip(cnt.gene, cnt[sample_id]))
    return out


def run_mine(tmp_path, rows, gene_df, exon_df, paired):
    bam_path = str(tmp_path / "s1.bam")
    flag = 0x1 if paired else 0x0
    recs = [(q, 0, p, flag, c, rnext, nh)
            for (q, p, c, nh, rnext) in rows]
    bamio.write_bam(bam_path, [CHROM], [CHROM_LEN], recs)
    hdr, cols = bamio.read_bam(bam_path, tid=0)
    overlap_dat = overlap_structure(gene_df)
    return chromosome_coverage_read_counts(
        cols, CHROM, CHROM_LEN, gene_df, exon_df, overlap_dat,
        paired=paired, unique_alignment=True, compat="reference")


@pytest.mark.parametrize("paired", [False, True])
def test_coverage_matches_reference(tmp_path, annotation, paired):
    gene_df, exon_df = annotation
    rng = np.random.default_rng(17 + int(paired))
    rows = synth_reads(rng, gene_df, exon_df, n=400, paired=paired)

    ref = run_reference(tmp_path, rows, gene_df, exon_df, paired)
    mine = run_mine(tmp_path, rows, gene_df, exon_df, paired)

    assert mine.read_counts == ref["counts"]
    for g, v in ref["overlap"].items():
        np.testing.assert_array_equal(
            mine.overlap_coverage[g], v, err_msg=f"overlap gene {g}")
    if ref["iso"] is not None:
        np.testing.assert_array_equal(mine.isolated_coverage, ref["iso"])


def test_overlap_structure_matches_reference(annotation):
    gene_df, _ = annotation
    _stub_modules()
    from degnorm.gene_processing import get_gene_overlap_structure
    ref = get_gene_overlap_structure(gene_df)
    mine = overlap_structure(gene_df)
    assert sorted(mine["isolated_genes"]) == sorted(ref["isolated_genes"])
    assert (sorted(map(sorted, mine["overlap_genes"]))
            == sorted(map(sorted, ref["overlap_genes"])))


def test_overlap_structure_chain():
    """Reference test case: A-B-C chained overlap + isolated D
    (tests/test_gene_processing.py:45-47)."""
    df = pd.DataFrame({
        "gene": ["A", "B", "C", "D"],
        "gene_start": [100, 150, 215, 600],
        "gene_end": [200, 230, 280, 822]})
    out = overlap_structure(df)
    assert out["isolated_genes"] == ["D"]
    assert sorted(map(sorted, out["overlap_genes"])) == [["A", "B", "C"]]


def test_warm_start_from_reference_written_run(tmp_path, annotation):
    """MIGRATION PATH: our pipeline warm-starts from a run directory whose
    artifacts were written by the REFERENCE implementation's own ETL +
    merge code (reads.py coverage artifacts -> reads_coverage_merge
    merge_read_counts/merge_coverage -> the __main__.py:199-209 csv
    writes), so a reference user can switch frameworks without re-parsing
    BAMs."""
    gene_df, exon_df = annotation
    rng = np.random.default_rng(11)
    data_dir = tmp_path / "ref_etl"
    sample_ids = ["s1", "s2"]
    for sid in sample_ids:
        rows = synth_reads(rng, gene_df, exon_df, n=500, paired=False)
        run_reference(tmp_path, rows, gene_df, exon_df, paired=False,
                      sample_id=sid, save_dir=str(data_dir / sid))

    # the reference's own merge layer writes the warm-startable artifacts
    from degnorm.reads_coverage_merge import (merge_coverage,
                                              merge_read_counts)
    ref_run = tmp_path / "ref_run"
    os.makedirs(ref_run)
    counts_df = merge_read_counts(str(data_dir), sample_ids, [CHROM])
    cov_dict = merge_coverage(str(data_dir), sample_ids, exon_df,
                              n_jobs=1, output_dir=str(ref_run),
                              verbose=False)
    counts_df.to_csv(os.path.join(ref_run, "read_counts.csv"), index=False)
    exon_df.to_csv(os.path.join(ref_run, "gene_exon_metadata.csv"),
                   index=False)
    assert os.path.isfile(os.path.join(
        ref_run, CHROM, f"coverage_matrices_{CHROM}.pkl"))

    # our CLI, warm-started from the reference-written directory
    from degnorm_jax.cli import main
    out_base = tmp_path / "ours"
    os.makedirs(out_base)
    rc = main(["-w", str(ref_run), "-o", str(out_base),
               "--nmf-iter", "5", "--iter", "2"])
    assert rc == 0
    run_dir = [p for p in os.listdir(out_base) if p.startswith("degnorm_")]
    di = pd.read_csv(os.path.join(out_base, run_dir[0],
                                  "degradation_index_scores.csv"))
    assert set(di.columns) >= {"chr", "gene"} | set(sample_ids)
    assert set(di.gene) == set(cov_dict.keys())
    assert np.isfinite(di[sample_ids].values).all()


def test_reference_warm_starts_from_our_run(tmp_path, annotation):
    """Reverse migration: the REFERENCE's own warm_start.load_from_previous
    consumes a run directory OUR pipeline wrote — the artifact contract is
    compatible in both directions."""
    gene_df, exon_df = annotation
    del gene_df
    # produce one of OUR runs on simulated BAMs
    from degnorm_jax.io.simulate import make_genes, write_gtf, \
        write_sample_bam
    from degnorm_jax.cli import main
    rng = np.random.default_rng(21)
    genes = make_genes(rng, n_genes=6, overlap_fraction=0.2)
    gtf = str(tmp_path / "sim.gtf")
    write_gtf(gtf, genes)
    bams = []
    for i in range(2):
        b = str(tmp_path / f"sample{i}.bam")
        write_sample_bam(b, genes, 60_000, seed=30 + i,
                         mean_reads_per_gene=120)
        bams.append(b)
    out_base = tmp_path / "ours"
    os.makedirs(out_base)
    rc = main(["--bam-files", *bams, "-g", gtf, "-o", str(out_base),
               "--nmf-iter", "5", "--iter", "1"])
    assert rc == 0
    run_dir = os.path.join(out_base, [p for p in os.listdir(out_base)
                                      if p.startswith("degnorm_")][0])

    # the reference's warm-start loader reads it
    _stub_modules()
    from degnorm.warm_start import load_from_previous
    new_dir = str(tmp_path / "ref_new")
    os.makedirs(new_dir)
    out = load_from_previous(run_dir, new_dir)
    gene_cov_dict = out["gene_cov_dict"]
    assert out["sample_ids"] == ["sample0", "sample1"]
    assert set(out["genes_df"].gene) == set(gene_cov_dict.keys())
    for g, mat in gene_cov_dict.items():
        assert mat.ndim == 2 and mat.shape[0] == 2   # p x L_i orientation
    # the loader also copied the artifacts into the new run dir
    assert os.path.isfile(os.path.join(new_dir, "read_counts.csv"))
