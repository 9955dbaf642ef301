"""Property-based fuzzing of the ETL compat layer: random annotations and
random read sets must produce identical results from the C++ kernel, the
vectorized numpy path, and the reference implementation."""
import numpy as np
import pandas as pd
from hypothesis import given, settings, strategies as st

from degnorm_jax.io import bam as bamio
from degnorm_jax.io.coverage import chromosome_coverage_read_counts
from degnorm_jax.io.overlap import overlap_structure
from tests.test_coverage_parity import run_reference

CHROM = "chr1"
CHROM_LEN = 30_000

CIGAR_OPS = ["M", "N", "D", "X", "S", "H", "I"]


@st.composite
def annotation(draw):
    n_genes = draw(st.integers(2, 5))
    rows = []
    pos = draw(st.integers(500, 2000))
    for i in range(n_genes):
        n_ex = draw(st.integers(1, 3))
        for _ in range(n_ex):
            length = draw(st.integers(80, 500))
            rows.append((CHROM, pos, pos + length - 1, f"g{i}"))
            pos += length + draw(st.integers(20, 300))
        # sometimes overlap the next gene into this one
        if draw(st.booleans()):
            pos -= draw(st.integers(0, 250))
            pos = max(pos, rows[-1][1] + 5)
    exon_df = pd.DataFrame(rows, columns=["chr", "start", "end", "gene"])
    gene_df = exon_df.groupby(["chr", "gene"], as_index=False).agg(
        gene_start=("start", "min"), gene_end=("end", "max"))
    return exon_df.merge(gene_df, on=["chr", "gene"]), gene_df


@st.composite
def reads(draw, paired):
    n = draw(st.integers(5, 60))
    rows = []
    for i in range(n):
        pos = draw(st.integers(0, CHROM_LEN - 600))
        n_seg = draw(st.integers(1, 3))
        cigar = ""
        for s in range(n_seg):
            if s > 0:
                op = draw(st.sampled_from(CIGAR_OPS[1:]))
                cigar += f"{draw(st.integers(1, 200))}{op}"
            cigar += f"{draw(st.integers(5, 120))}M"
        nh = draw(st.sampled_from([1, 1, 1, 2]))
        if paired:
            mpos = pos + draw(st.integers(-50, 200))
            mpos = max(0, min(mpos, CHROM_LEN - 600))
            rows.append((f"q.{i}.1", pos, cigar, nh, 0))
            rows.append((f"q.{i}.2", mpos, f"{draw(st.integers(5,120))}M",
                         nh, 0))
        else:
            rows.append((f"q.{i}", pos, cigar, nh, -1))
    rows.sort(key=lambda r: r[1])
    return rows


def _run_all_paths(tmpdir, ann, rows, paired):
    gene_df, exon_df = ann[1], ann[0]
    ref = run_reference(tmpdir, rows, gene_df, exon_df, paired,
                        chrom_len=CHROM_LEN)

    flag = 0x1 if paired else 0x0
    recs = [(q, 0, p, flag, c, rnext, nh) for (q, p, c, nh, rnext) in rows]
    bam = str(tmpdir / "f.bam")
    bamio.write_bam(bam, [CHROM], [CHROM_LEN], recs)
    _, cols = bamio.read_bam(bam, tid=0)
    ov = overlap_structure(gene_df)
    kw = dict(paired=paired, unique_alignment=True, compat="reference")
    out_np = chromosome_coverage_read_counts(
        cols, CHROM, CHROM_LEN, gene_df, exon_df, ov, native=False, **kw)
    out_c = chromosome_coverage_read_counts(
        cols, CHROM, CHROM_LEN, gene_df, exon_df, ov, native=True, **kw)

    for out in (out_np, out_c):
        assert out.read_counts == ref["counts"]
        for g, v in ref["overlap"].items():
            np.testing.assert_array_equal(out.overlap_coverage[g], v)
        if ref["iso"] is not None and out.isolated_coverage is not None:
            np.testing.assert_array_equal(out.isolated_coverage, ref["iso"])


@settings(max_examples=25, deadline=None)
@given(ann=annotation(), data=st.data())
def test_fuzz_single_end(tmp_path_factory, ann, data):
    rows = data.draw(reads(paired=False))
    _run_all_paths(tmp_path_factory.mktemp("fz"), ann, rows, False)


@settings(max_examples=25, deadline=None)
@given(ann=annotation(), data=st.data())
def test_fuzz_paired(tmp_path_factory, ann, data):
    rows = data.draw(reads(paired=True))
    _run_all_paths(tmp_path_factory.mktemp("fz"), ann, rows, True)
