"""Native (C++) BAM reader parity with the pure-Python decoder."""
import os

import numpy as np
import pytest

from degnorm_jax.io import bam as bamio
from degnorm_jax.io.native.build import load_library
from degnorm_jax.io.simulate import make_genes, write_sample_bam


@pytest.fixture(scope="module")
def bam_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("nbam")
    rng = np.random.default_rng(3)
    genes = make_genes(rng, n_genes=6)
    path = str(d / "s.bam")
    write_sample_bam(path, genes, 100_000, seed=5,
                     mean_reads_per_gene=200, paired=True)
    return path


def test_native_library_builds():
    assert load_library() is not None, "g++ toolchain should be available"


@pytest.mark.parametrize("tid", [None, 0])
def test_native_matches_python(bam_file, tid):
    hdr_py, cols_py = bamio.read_bam(bam_file, tid=tid, native=False)
    out = bamio._read_bam_native(bam_file, tid=tid, drop_unmapped=True)
    assert out is not None
    hdr_c, cols_c = out

    assert hdr_c.ref_names == hdr_py.ref_names
    assert hdr_c.ref_lengths == hdr_py.ref_lengths
    assert list(cols_c.qnames) == list(cols_py.qnames)
    for field in ("tid", "pos", "flag", "rnext", "nh",
                  "cigar_ops", "cigar_lens", "cigar_offsets"):
        np.testing.assert_array_equal(
            getattr(cols_c, field), getattr(cols_py, field), err_msg=field)


def test_native_is_default(bam_file, monkeypatch):
    monkeypatch.delenv("DEGNORM_JAX_NO_NATIVE", raising=False)
    hdr, cols = bamio.read_bam(bam_file)
    assert len(cols) > 0


def test_native_coverage_kernel_matches_numpy(bam_file):
    """The C++ coverage kernel must equal the numpy implementation exactly
    (which is itself byte-equal to the reference)."""
    from degnorm_jax.io.coverage import chromosome_coverage_read_counts
    from degnorm_jax.io.gtf import gene_outline
    from degnorm_jax.io.overlap import overlap_structure
    import pandas as pd
    from degnorm_jax.io.simulate import make_genes

    rng = np.random.default_rng(3)
    genes = make_genes(rng, n_genes=6)
    exon_rows = [("chr1", s, e, g.name, g.exons[0][0], g.exons[-1][1])
                 for g in genes for s, e in g.exons]
    exon_df = pd.DataFrame(exon_rows, columns=[
        "chr", "start", "end", "gene", "gene_start", "gene_end"])
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = overlap_structure(gene_df)
    hdr, cols = bamio.read_bam(bam_file, tid=0)

    kw = dict(paired=True, unique_alignment=True, compat="reference")
    a = chromosome_coverage_read_counts(
        cols, "chr1", 100_000, gene_df, exon_df, ov, native=False, **kw)
    b = chromosome_coverage_read_counts(
        cols, "chr1", 100_000, gene_df, exon_df, ov, native=True, **kw)
    assert a.read_counts == b.read_counts
    if a.isolated_coverage is not None:
        np.testing.assert_array_equal(a.isolated_coverage,
                                      b.isolated_coverage)
    for g in a.overlap_coverage:
        np.testing.assert_array_equal(a.overlap_coverage[g],
                                      b.overlap_coverage[g])


def test_lazy_qnames_container_contract():
    """LazyQnames (the native reader's lazy string view) must behave like
    the object ndarray it replaced: len/iter, int indexing, lazy
    array/mask/slice subsetting, tolist, np.asarray materialization, and
    the numpy>=2 __array__(copy=True) no-aliasing contract."""
    import numpy as np
    from degnorm_jax.io.bam import LazyQnames

    blob = b"read.1\x00r2\x00longername.2\x00x\x00"
    offs = np.array([0, 7, 10, 23, 25], np.int64)
    lq = LazyQnames(blob, offs[:-1], offs[1:] - 1)
    assert len(lq) == 4
    assert lq[0] == "read.1" and lq[2] == "longername.2"
    assert list(lq) == ["read.1", "r2", "longername.2", "x"]
    assert lq.tolist() == ["read.1", "r2", "longername.2", "x"]
    # lazy subsetting: int array, bool mask, slice — no materialization
    sub = lq[np.array([2, 0])]
    assert isinstance(sub, LazyQnames) and sub.tolist() == \
        ["longername.2", "read.1"]
    masked = lq[np.array([True, False, True, False])]
    assert masked.tolist() == ["read.1", "longername.2"]
    assert lq[1:3].tolist() == ["r2", "longername.2"]
    # np.asarray materializes; copy=True must not alias the shared cache
    a = np.asarray(lq)
    assert a.dtype == object and a[1] == "r2"
    b = np.array(lq)            # numpy>=2: copy=True by default
    b[1] = "mutated"
    assert np.asarray(lq)[1] == "r2"


def test_read_header_growing_prefix(tmp_path):
    """read_header must survive prefixes that truncate a BGZF block
    mid-payload (zlib.error, not ValueError) and grow until the header
    parses — the code-review-reproduced crash for headers spanning past
    the initial prefix."""
    from degnorm_jax.io import bam as bamio
    path = str(tmp_path / "hdr.bam")
    names = [f"chr{i}" for i in range(200)]
    bamio.write_bam(path, names, [1000] * len(names),
                    [(f"q{i}", i % len(names), 5, 0, "10M", -1)
                     for i in range(50)])
    full = bamio.read_header(path)
    for prefix in (64, 100, 4096):
        h = bamio.read_header(path, _initial_prefix=prefix)
        assert h.ref_names == full.ref_names
        assert h.ref_lengths == full.ref_lengths


@pytest.mark.parametrize("paired", [False, True])
def test_native_coverage_kernel_threaded_bit_identical(bam_file, paired,
                                                       tmp_path):
    """IN-CHROMOSOME threading (round-5 verdict item 3): the threaded C++
    coverage kernel must be BIT-IDENTICAL to the serial kernel at any
    thread count — all accumulation is commutative integer adds (relaxed
    atomics), so this is a hard equality, not a tolerance."""
    from degnorm_jax.io.coverage import chromosome_coverage_read_counts
    from degnorm_jax.io.overlap import overlap_structure
    import pandas as pd
    from degnorm_jax.io.simulate import make_genes, write_sample_bam

    rng = np.random.default_rng(11)
    genes = make_genes(rng, n_genes=8, overlap_fraction=0.3)
    path = str(tmp_path / "t.bam")
    write_sample_bam(path, genes, 120_000, seed=7,
                     mean_reads_per_gene=300, paired=paired)
    exon_rows = [("chr1", s, e, g.name, g.exons[0][0], g.exons[-1][1])
                 for g in genes for s, e in g.exons]
    exon_df = pd.DataFrame(exon_rows, columns=[
        "chr", "start", "end", "gene", "gene_start", "gene_end"])
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = overlap_structure(gene_df)
    hdr, cols = bamio.read_bam(path, tid=0)

    kw = dict(paired=paired, unique_alignment=True, compat="reference",
              native=True)
    serial = chromosome_coverage_read_counts(
        cols, "chr1", 120_000, gene_df, exon_df, ov, n_threads=1, **kw)
    for nt in (2, 4, 7):
        thr = chromosome_coverage_read_counts(
            cols, "chr1", 120_000, gene_df, exon_df, ov, n_threads=nt,
            **kw)
        assert thr.read_counts == serial.read_counts, f"nt={nt}"
        if serial.isolated_coverage is not None:
            np.testing.assert_array_equal(
                thr.isolated_coverage, serial.isolated_coverage,
                err_msg=f"nt={nt}")
        assert set(thr.overlap_coverage) == set(serial.overlap_coverage)
        for g in serial.overlap_coverage:
            np.testing.assert_array_equal(
                thr.overlap_coverage[g], serial.overlap_coverage[g],
                err_msg=f"nt={nt} gene {g}")
