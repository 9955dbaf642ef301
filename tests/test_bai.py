"""BAI index write/read and region fetch (the samtools-index equivalent)."""
import os

import numpy as np
import pytest

from degnorm_jax.io import bam as bamio
from degnorm_jax.io.bai import read_bai, reg2bin, reg2bins
from degnorm_jax.io.simulate import make_genes, simulate_sample


def test_reg2bin_spec_cases():
    # bin 0 covers the whole reference; small windows land in leaf bins
    assert reg2bin(0, 1 << 29) == 0
    leaf = reg2bin(0, 100)
    assert 4681 <= leaf <= 4681 + (1 << 15) - 1
    assert reg2bin(16384, 16484) == 4681 + 1
    # reg2bins always includes every level's covering bin
    bins = reg2bins(20000, 30000)
    assert 0 in bins and reg2bin(20000, 30000) in bins


@pytest.fixture(scope="module")
def indexed_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("bai")
    rng = np.random.default_rng(9)
    g1 = make_genes(rng, chrom="c1", n_genes=5, name_prefix="a.")
    g2 = make_genes(rng, chrom="c2", n_genes=4, name_prefix="b.")
    recs = []
    for tid, genes in enumerate((g1, g2)):
        sub = simulate_sample(np.random.default_rng(50 + tid), genes,
                              80_000, mean_reads_per_gene=120)
        recs.extend((r[0], tid, *r[2:]) for r in sub)
    bam = str(d / "x.bam")
    bai = bam + ".bai"
    bamio.write_bam(bam, ["c1", "c2"], [80_000, 80_000], recs,
                    index_path=bai)
    return bam, bai


def test_bai_roundtrip(indexed_bam):
    bam, bai = indexed_bam
    idx = read_bai(bai)
    assert len(idx.bins) == 2
    assert all(idx.bins[t] for t in (0, 1))
    # chunks are sorted, non-overlapping after merge
    ch = idx.chunks_for(0)
    assert ch == sorted(ch)
    for (s1, e1), (s2, e2) in zip(ch, ch[1:]):
        assert e1 <= s2


def test_region_fetch_matches_streaming(indexed_bam):
    bam, bai = indexed_bam
    for tid in (0, 1):
        hdr_s, cols_s = bamio.read_bam(bam, tid=tid, native=False)
        hdr_r, cols_r = bamio.read_bam_region(bam, bai, tid=tid)
        assert list(cols_r.qnames) == list(cols_s.qnames)
        np.testing.assert_array_equal(cols_r.pos, cols_s.pos)
        np.testing.assert_array_equal(cols_r.cigar_lens, cols_s.cigar_lens)


def test_region_fetch_window(indexed_bam):
    bam, bai = indexed_bam
    hdr, all_cols = bamio.read_bam(bam, tid=0, native=False)
    beg, end = 3000, 9000
    _, win = bamio.read_bam_region(bam, bai, tid=0, beg=beg, end=end)
    expect = {q for q, p in zip(all_cols.qnames, all_cols.pos)
              if beg <= p < end}
    assert set(win.qnames) == expect


def test_index_bam_matches_write_time_index(indexed_bam, tmp_path):
    """Post-hoc indexing of an existing BAM (the native samtools-index
    equivalent) must yield identical region fetches to the index written
    at BAM-creation time."""
    from degnorm_jax.io.bai import index_bam

    bam, bai = indexed_bam
    bai2 = str(tmp_path / "rebuilt.bai")
    index_bam(bam, bai2)
    for tid in (0, 1):
        _, a = bamio.read_bam_region(bam, bai, tid=tid)
        _, b = bamio.read_bam_region(bam, bai2, tid=tid)
        assert list(a.qnames) == list(b.qnames)
        np.testing.assert_array_equal(a.pos, b.pos)


def test_read_head_qnames(indexed_bam):
    bam, _ = indexed_bam
    _, cols = bamio.read_bam(bam, native=False)
    head = bamio.read_head_qnames(bam, 50)
    assert head == list(cols.qnames[:50])
    # asking beyond EOF returns everything
    assert bamio.read_head_qnames(bam, 10 ** 6) == list(cols.qnames)


def test_streaming_sample_processor_matches_whole_file(indexed_bam, tmp_path):
    """BAI-driven per-chromosome streaming ETL (pipeline/sample.py) must be
    byte-identical to the whole-file decode path."""
    import pandas as pd
    from degnorm_jax.pipeline.sample import BamSampleProcessor

    bam, bai = indexed_bam
    gene_rows, exon_rows = [], []
    # build annotation from the simulated genes deterministically
    rng = np.random.default_rng(9)
    g1 = make_genes(rng, chrom="c1", n_genes=5, name_prefix="a.")
    g2 = make_genes(rng, chrom="c2", n_genes=4, name_prefix="b.")
    for genes in (g1, g2):
        for g in genes:
            gene_rows.append((g.chrom, g.name,
                              min(s for s, _ in g.exons),
                              max(e for _, e in g.exons)))
            for s, e in g.exons:
                exon_rows.append((g.chrom, g.name, s, e))
    gene_df = pd.DataFrame(gene_rows,
                           columns=["chr", "gene", "gene_start", "gene_end"])
    exon_df = pd.DataFrame(exon_rows, columns=["chr", "gene", "start", "end"])
    overlap = {c: {"overlap_genes": [],
                   "isolated_genes": list(gene_df[gene_df.chr == c].gene)}
               for c in ("c1", "c2")}

    whole = BamSampleProcessor(bam, stream=False)
    streamed = BamSampleProcessor(bam, stream=True)
    assert streamed.stream and streamed.bai_file == bai
    assert streamed.paired == whole.paired

    r_w = whole.coverage_read_counts(overlap, gene_df, exon_df)
    r_s = streamed.coverage_read_counts(overlap, gene_df, exon_df)
    for chrom in ("c1", "c2"):
        assert r_s[chrom].read_counts == r_w[chrom].read_counts
        np.testing.assert_array_equal(r_s[chrom].isolated_coverage,
                                      r_w[chrom].isolated_coverage)


def test_native_region_parse_matches_python(indexed_bam):
    """dn_parse_records on a BAI region blob == the pure-Python parser."""
    from degnorm_jax.io.bai import fetch_region_bytes, read_bai

    bam, bai = indexed_bam
    idx = read_bai(bai)
    for tid, rng in ((0, (0, 1 << 29)), (1, (3000, 9000))):
        blob = fetch_region_bytes(bam, idx, tid, *rng)
        py = bamio._parse_records(blob, tid=tid, pos_range=rng)
        nat = bamio._parse_records_native(blob, tid=tid, pos_range=rng)
        if nat is None:
            import pytest
            pytest.skip("no native toolchain")
        assert list(nat.qnames) == list(py.qnames)
        np.testing.assert_array_equal(nat.pos, py.pos)
        np.testing.assert_array_equal(nat.cigar_ops, py.cigar_ops)
        np.testing.assert_array_equal(nat.cigar_lens, py.cigar_lens)
        np.testing.assert_array_equal(nat.cigar_offsets, py.cigar_offsets)
        np.testing.assert_array_equal(nat.nh, py.nh)
        np.testing.assert_array_equal(nat.rnext, py.rnext)


@pytest.fixture(scope="module")
def multiblock_bam(tmp_path_factory):
    """A BAM spanning many BGZF blocks (incompressible qnames, >1 MB) —
    exercises incremental readers across chunk boundaries."""
    import secrets
    d = tmp_path_factory.mktemp("big")
    bam = str(d / "big.bam")
    rng = np.random.default_rng(0)
    recs, pos = [], 100
    for i in range(60000):
        pos += int(rng.integers(0, 50))
        recs.append((f"{secrets.token_hex(12)}.{i % 2 + 1}", 0, pos,
                     0x1, "75M", 0))
    bamio.write_bam(bam, ["c1"], [pos + 10_000], recs)
    assert os.path.getsize(bam) > (1 << 20)
    return bam


def test_read_head_qnames_multichunk(multiblock_bam):
    """Regression: the incremental head reader must survive growing its
    raw buffer while a memoryview existed (BufferError pre-fix)."""
    _, cols = bamio.read_bam(multiblock_bam, native=False)
    head = bamio.read_head_qnames(multiblock_bam, 30000)
    assert head == list(cols.qnames[:30000])


def test_streaming_index_bam_multiblock(multiblock_bam, tmp_path):
    """The streaming (bounded-memory) indexer on a many-block file yields
    fetches identical to a full scan."""
    from degnorm_jax.io.bai import index_bam
    bai = index_bam(multiblock_bam, str(tmp_path / "x.bai"))
    _, full = bamio.read_bam(multiblock_bam, tid=0, native=False)
    _, reg = bamio.read_bam_region(multiblock_bam, bai, tid=0)
    assert list(reg.qnames) == list(full.qnames)
    beg, end = 200_000, 400_000
    _, win = bamio.read_bam_region(multiblock_bam, bai, tid=0,
                                   beg=beg, end=end)
    expect = {q for q, p in zip(full.qnames, full.pos) if beg <= p < end}
    assert set(win.qnames) == expect
