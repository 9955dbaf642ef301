"""CRAM 3.0 reader/writer and rANS codec tests.

The reference supports only .bam input (``loaders.py:44-70``); CRAM is a
completeness extension (io/cram.py).  htslib/pysam are not installable in
this environment, so — as with the stripped reference BAM blobs
(SURVEY.md §4) — fixtures are synthesized in-repo and the decoder is
validated against the independently-tested BAM path on identical record
streams, plus spec-level unit tests of each encoding and codec.
"""
import os
import struct

import numpy as np
import pytest

from degnorm_jax.io import bam as bamio
from degnorm_jax.io import cram as cramio
from degnorm_jax.io import rans
from degnorm_jax.io.simulate import (make_genes, simulate_sample,
                                     write_gtf, write_sample_bam,
                                     write_sample_cram)

CHROM_LEN = 80_000


# ---------------------------------------------------------------------------
# rANS 4x8 codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [0, 1])
def test_rans_roundtrip_distributions(order):
    rng = np.random.default_rng(0)
    cases = [
        b"", b"x", b"ab", b"abc",
        b"\x00" * 1000,
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),      # uniform
        bytes(rng.integers(65, 68, 9999, dtype=np.uint8)),      # tiny alpha
        bytes((rng.pareto(0.5, 5000) % 256).astype(np.uint8)),  # skewed
        bytes(np.arange(256, dtype=np.uint8)) * 3,              # all symbols
        bytes(range(250, 256)) * 11,                            # top RLE run
    ]
    for data in cases:
        assert rans.uncompress(rans.compress(data, order=order)) == data


def test_rans_compresses_skewed_data():
    data = bytes(np.random.default_rng(1).integers(97, 100, 20000,
                                                   dtype=np.uint8))
    assert len(rans.compress(data, order=0)) < len(data) // 2
    assert len(rans.compress(data, order=1)) < len(data) // 2


def test_rans_fuzz_roundtrip():
    rng = np.random.default_rng(7)
    for _ in range(40):
        n = int(rng.integers(0, 3000))
        k = int(rng.integers(1, 256))
        data = bytes(rng.integers(0, k, n, dtype=np.uint8))
        for order in (0, 1):
            assert rans.uncompress(rans.compress(data, order=order)) == data


def test_rans_native_matches_python():
    """C++ decoder (io/native/rans_kernel.cpp) is byte-identical to the
    Python reference on valid streams AND agrees (same bytes or both
    erroring) on corrupted ones.  Skips when no toolchain built the
    native library."""
    from degnorm_jax.io.native.build import get_fn
    if get_fn("dn_rans_uncompress") is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(13)
    for t in range(30):
        n = int(rng.integers(0, 4000))
        k = int(rng.integers(1, 256))
        data = bytes(rng.integers(0, k, n, dtype=np.uint8))
        order = t % 2
        enc = rans.compress(data, order=order)
        assert rans.uncompress(enc, native=True) == data
        assert rans.uncompress(enc, native=False) == data
        if len(enc) > 25:
            bad = bytearray(enc)
            bad[int(rng.integers(20, len(bad)))] ^= int(
                rng.integers(1, 256))

            def run(native):
                try:
                    return rans.uncompress(bytes(bad), native=native)
                except ValueError:
                    return ("ERR",)
            assert run(True) == run(False)


def test_rans_truncation_detected():
    enc = rans.compress(b"hello world" * 50, order=0)
    with pytest.raises(ValueError):
        rans.uncompress(enc[:8])
    # body shorter than the declared compressed size
    with pytest.raises(ValueError):
        rans.uncompress(enc[:-10])


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def test_itf8_roundtrip():
    vals = [0, 1, 127, 128, 5000, 1 << 13, (1 << 14) - 1, 1 << 14,
            (1 << 21) - 1, 1 << 21, (1 << 28) - 1, 1 << 28,
            (1 << 31) - 1, -1, -2, -(1 << 31), 4_542_278]
    for v in vals:
        buf = bytearray()
        cramio.write_itf8(buf, v)
        got, off = cramio.read_itf8(bytes(buf), 0)
        assert got == v and off == len(buf), v


def test_ltf8_roundtrip():
    vals = [0, 1, 127, 128, (1 << 14) - 1, 1 << 20, 1 << 31, 1 << 40,
            1 << 50, (1 << 63) - 1, -1]
    for v in vals:
        buf = bytearray()
        cramio.write_ltf8(buf, v)
        got, off = cramio.read_ltf8(bytes(buf), 0)
        assert got == v and off == len(buf), v


# ---------------------------------------------------------------------------
# encodings (spec-level units with hand-built core/external data)
# ---------------------------------------------------------------------------

def _make_encoding(codec, params_builder):
    p = bytearray()
    params_builder(p)
    return cramio.Encoding(codec, bytes(p))


def test_huffman_multi_symbol():
    # canonical code over symbols 5,6,7 with lengths 1,2,2:
    # sorted (len, sym): 5->0, 6->10, 7->11
    def build(p):
        cramio.write_itf8(p, 3)
        for s in (5, 6, 7):
            cramio.write_itf8(p, s)
        cramio.write_itf8(p, 3)
        for ln in (1, 2, 2):
            cramio.write_itf8(p, ln)
    enc = _make_encoding(cramio.E_HUFFMAN, build)
    bw = cramio.BitWriter()
    for bits, n in [(0b0, 1), (0b10, 2), (0b11, 2), (0b0, 1), (0b11, 2)]:
        bw.write(bits, n)
    core = cramio.BitReader(bw.getvalue())
    out = [enc.read_int(core, {}) for _ in range(5)]
    assert out == [5, 6, 7, 5, 7]


def test_huffman_constant_reads_no_bits():
    def build(p):
        cramio.write_itf8(p, 1)
        cramio.write_itf8(p, -1)
        cramio.write_itf8(p, 1)
        cramio.write_itf8(p, 0)
    enc = _make_encoding(cramio.E_HUFFMAN, build)
    core = cramio.BitReader(b"")        # empty core: zero bits consumed
    assert [enc.read_int(core, {}) for _ in range(3)] == [-1, -1, -1]
    assert core.pos == 0


def test_beta_encoding():
    def build(p):
        cramio.write_itf8(p, 10)        # offset
        cramio.write_itf8(p, 6)         # bits
    enc = _make_encoding(cramio.E_BETA, build)
    bw = cramio.BitWriter()
    for v in (12, 0, 63):
        bw.write(v, 6)
    core = cramio.BitReader(bw.getvalue())
    assert [enc.read_int(core, {}) for _ in range(3)] == [2, -10, 53]


def test_gamma_encoding():
    def build(p):
        cramio.write_itf8(p, 0)
    enc = _make_encoding(cramio.E_GAMMA, build)
    bw = cramio.BitWriter()
    # Elias gamma: 1 -> "1"; 2 -> "010"; 5 -> "00101"
    bw.write(0b1, 1)
    bw.write(0b010, 3)
    bw.write(0b00101, 5)
    core = cramio.BitReader(bw.getvalue())
    assert [enc.read_int(core, {}) for _ in range(3)] == [1, 2, 5]


def test_byte_array_len_with_huffman_const_length():
    def build(p):
        inner = bytearray()
        # length: huffman constant 4
        lp = bytearray()
        cramio.write_itf8(lp, 1)
        cramio.write_itf8(lp, 4)
        cramio.write_itf8(lp, 1)
        cramio.write_itf8(lp, 0)
        cramio._write_encoding(inner, cramio.E_HUFFMAN, bytes(lp))
        # values: external block 9
        vp = bytearray()
        cramio.write_itf8(vp, 9)
        cramio._write_encoding(inner, cramio.E_EXTERNAL, bytes(vp))
        p += inner
    enc = _make_encoding(cramio.E_BYTE_ARRAY_LEN, build)
    ext = {9: cramio._Ext(b"abcdWXYZ")}
    core = cramio.BitReader(b"")
    assert enc.read_array(core, ext) == b"abcd"
    assert enc.read_array(core, ext) == b"WXYZ"


def test_unsupported_encoding_rejected():
    with pytest.raises(ValueError, match="GOLOMB"):
        cramio.Encoding(cramio.E_GOLOMB, b"\x00\x00")


# ---------------------------------------------------------------------------
# file roundtrip vs the BAM path
# ---------------------------------------------------------------------------

_RECS = [
    ("r1.1", 0, 100, 0x1 | 0x40, "50M", 0, 2),
    ("r1.2", 0, 200, 0x1 | 0x80, "10S40M", 0, 2),
    ("lone", 0, 300, 0x0, "20M100N30M", -1, 1),
    ("clip", 1, 50, 0x0, "5H25M3D10M2S", -1, 1),
    ("ins", 0, 400, 0x0, "10M2I38M", -1, None),
    ("plain", 1, 500, 0x0, "60M", -1, 4),
]
_REFS, _LENS = ["chr1", "chr2"], [10_000, 20_000]


def _bam_cols(tmp_path):
    bp = str(tmp_path / "t.bam")
    bamio.write_bam(bp, _REFS, _LENS, _RECS)
    return bamio.read_bam(bp, native=False)[1]


@pytest.mark.parametrize("compression", ["raw", "gzip", "rans"])
def test_cram_matches_bam_columns(tmp_path, compression):
    bc = _bam_cols(tmp_path)
    cp = str(tmp_path / "t.cram")
    cramio.write_cram(cp, _REFS, _LENS, _RECS, compression=compression)
    hdr, cc = cramio.read_cram(cp)
    assert hdr.ref_names == _REFS and hdr.ref_lengths == _LENS
    assert list(cc.qnames) == list(bc.qnames)
    for f in ("tid", "pos", "flag", "rnext", "nh",
              "cigar_ops", "cigar_lens", "cigar_offsets"):
        assert np.array_equal(getattr(cc, f), getattr(bc, f)), f


@pytest.mark.parametrize("kwargs", [
    dict(preserve_names=False),
    dict(ap_delta=False),
    dict(records_per_slice=2),          # multi-slice, multi-container
    dict(link_mates=True),
])
def test_cram_variants_match_bam(tmp_path, kwargs):
    bc = _bam_cols(tmp_path)
    cp = str(tmp_path / "v.cram")
    cramio.write_cram(cp, _REFS, _LENS, _RECS, **kwargs)
    _, cc = cramio.read_cram(cp)
    for f in ("tid", "pos", "nh", "cigar_ops", "cigar_lens",
              "cigar_offsets"):
        assert np.array_equal(getattr(cc, f), getattr(bc, f)), f
    if kwargs.get("preserve_names", True):
        assert list(cc.qnames) == list(bc.qnames)
    else:
        # generated names must still pair identically-named mates
        assert len(set(cc.qnames)) == len(cc.qnames)
    if not kwargs.get("link_mates"):
        assert np.array_equal(cc.flag, bc.flag)
        assert np.array_equal(cc.rnext, bc.rnext)
    else:
        # linked mates reconstruct rnext from each other within the slice
        assert np.array_equal(cc.rnext, bc.rnext)


def test_cram_linked_mates_share_generated_names(tmp_path):
    # real-world SAM convention: both mates share one QNAME — that is
    # what link_mates keys on (the reference's '.1'/'.2' suffix scheme in
    # _RECS stays detached, reads.py:184-203 sniff semantics)
    recs = [
        ("pair", 0, 100, 0x1 | 0x40, "50M", 0, 1),
        ("pair", 0, 180, 0x1 | 0x80 | 0x10, "50M", 0, 1),
        ("solo", 0, 300, 0x0, "40M", -1, 1),
    ]
    cp = str(tmp_path / "lm.cram")
    cramio.write_cram(cp, _REFS, _LENS, recs, preserve_names=False,
                      link_mates=True)
    _, cc = cramio.read_cram(cp)
    # linked pair shares one generated name; the solo read gets its own
    assert cc.qnames[0] == cc.qnames[1]
    assert cc.qnames[2] != cc.qnames[0]
    # NF mate resolution reconstructs rnext and the mate flags
    assert cc.rnext[0] == 0 and cc.rnext[1] == 0
    assert cc.flag[0] & 0x20            # mate reverse, from mate's 0x10
    assert not (cc.flag[1] & 0x20)


def test_cram_link_mates_nf_path_exercised(tmp_path):
    """With shared qnames and link_mates, the writer must actually emit
    NF-linked records (guards against silently falling back to detached)."""
    recs = [("q1", 0, 10, 0x1, "30M", 0, 1),
            ("q1", 0, 90, 0x1, "30M", 0, 1)]
    cp = str(tmp_path / "nf.cram")
    cramio.write_cram(cp, _REFS, _LENS, recs, link_mates=True)
    blob = open(cp, "rb").read()
    # decode succeeds and the NS series (detached-only) stays empty:
    _, cc = cramio.read_cram(cp)
    assert list(cc.qnames) == ["q1", "q1"]
    assert np.array_equal(cc.rnext, [0, 0])
    assert b"NS" not in _used_series_keys(blob)


def _used_series_keys(blob):
    """Data-series keys with a non-empty external block in the first data
    container (writer emits one block per non-empty series)."""
    off = cramio._check_magic(blob)
    _, off, _ = cramio._read_file_header(blob, off)
    ch, off = cramio.read_container_header(blob, off)
    blk, off = cramio.read_block(blob, off)
    comp = cramio.read_compression_header(blk.data)
    sh_blk, off = cramio.read_block(blob, off)
    sh = cramio.read_slice_header(sh_blk.data)
    present = set()
    ids = set(sh.content_ids)
    for key, enc in comp.ds.items():
        cid = getattr(enc, "cid", None)
        if cid is not None and cid in ids:
            present.add(key.encode())
    return present


def test_cram_simulated_sample_matches_bam(tmp_path):
    rng = np.random.default_rng(3)
    genes = make_genes(rng, n_genes=6, overlap_fraction=0.3)
    bp, cp = str(tmp_path / "s.bam"), str(tmp_path / "s.cram")
    for paired in (False, True):
        write_sample_bam(bp, genes, CHROM_LEN, seed=11, paired=paired,
                         mean_reads_per_gene=80, degradation=0.4)
        write_sample_cram(cp, genes, CHROM_LEN, seed=11, paired=paired,
                          mean_reads_per_gene=80, degradation=0.4)
        _, bc = bamio.read_bam(bp, native=False)
        _, cc = cramio.read_cram(cp)
        assert list(cc.qnames) == list(bc.qnames)
        for f in ("tid", "pos", "flag", "rnext", "nh",
                  "cigar_ops", "cigar_lens", "cigar_offsets"):
            assert np.array_equal(getattr(cc, f), getattr(bc, f)), \
                (paired, f)


def test_cram_unmapped_and_tid_filters(tmp_path):
    recs = _RECS + [("un", 0, 600, 0x4, "", -1, None)]
    cp = str(tmp_path / "u.cram")
    cramio.write_cram(cp, _REFS, _LENS, recs)
    _, all_cols = cramio.read_cram(cp, drop_unmapped=False)
    assert len(all_cols) == len(recs)
    _, mapped = cramio.read_cram(cp)
    assert len(mapped) == len(_RECS)
    _, chr2 = cramio.read_cram(cp, tid=1)
    assert set(chr2.tid.tolist()) == {1} and len(chr2) == 2


def test_cram_error_paths(tmp_path):
    p = str(tmp_path / "bad.cram")
    with open(p, "wb") as f:
        f.write(b"BAMX" + b"\x00" * 30)
    with pytest.raises(ValueError, match="magic"):
        cramio.read_cram(p)
    with open(p, "wb") as f:
        f.write(b"CRAM" + bytes([3, 1]) + b"\x00" * 20)
    with pytest.raises((ValueError, IndexError, struct.error)):
        cramio.read_cram(p)          # truncated after the file definition
    # CRAM 3.1-only codec id in a block
    with pytest.raises(ValueError, match="3.1"):
        cramio._uncompress_block(b"xx", 5, 2)
    # corrupted block payload -> CRC32 mismatch (mid-file lands inside a
    # data block; block CRCs are verified before decompression)
    cp = str(tmp_path / "ok.cram")
    cramio.write_cram(cp, _REFS, _LENS, _RECS)
    blob = bytearray(open(cp, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(cp, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="CRC32"):
        cramio.read_cram(cp)


def test_cram_major_version_gate(tmp_path):
    p = str(tmp_path / "v2.cram")
    with open(p, "wb") as f:
        f.write(b"CRAM" + bytes([2, 1]) + b"\x00" * 20)
    with pytest.raises(ValueError, match="major version 2"):
        cramio.read_cram(p)


def test_fast_path_engages_on_writer_output(tmp_path, monkeypatch):
    """The vectorized decoder must actually handle the writer's encoding
    profile (guards against a silent permanent fallback to the 15x
    slower per-record path)."""
    from degnorm_jax.io import cram_fast
    if cram_fast._scan_itf8(b"\x01") is None:
        pytest.skip("native library unavailable")
    hits = {"ok": 0}
    orig = cram_fast._decode

    def spy(*a, **k):
        out = orig(*a, **k)
        hits["ok"] += 1
        return out
    monkeypatch.setattr(cram_fast, "_decode", spy)
    cp = str(tmp_path / "e.cram")
    cramio.write_cram(cp, _REFS, _LENS, _RECS, records_per_slice=3)
    _, cc = cramio.read_cram(cp)
    assert hits["ok"] == 2 and len(cc) == len(_RECS)


def _random_records(rng, n):
    """Random-but-valid record tuples: mixed chromosomes, occasional
    unmapped reads, random CIGARs over M/I/D/N/S/H/P, and same-qname runs
    of 2-4 (under link_mates these become NF chains; single tid + plain
    0x1 flags so NF resolution reconstructs exactly the written rnext and
    adds no mate flags — keeping BAM-column equality by construction
    while fuzzing the chain link/name logic)."""
    recs = []
    i = 0
    while i < n:
        tid = int(rng.integers(0, 2))
        pos = int(rng.integers(0, 5000))
        if rng.random() < 0.12:
            k = int(rng.integers(2, 5))
            for _ in range(k):
                cig = f"{int(rng.integers(1, 80))}M"
                nh = int(rng.integers(1, 4)) if rng.random() < 0.5 else None
                rec = (f"run{i}", tid, pos, 0x1, cig, tid)
                recs.append(rec if nh is None else rec + (nh,))
                pos += int(rng.integers(1, 200))
            i += 1
            continue
        i += 1
        if rng.random() < 0.08:
            recs.append((f"u{i}", tid, pos, 0x4, "", -1,
                         int(rng.integers(1, 4))))
            continue
        parts = []
        if rng.random() < 0.2:
            parts.append(f"{int(rng.integers(1, 9))}H")
        if rng.random() < 0.3:
            parts.append(f"{int(rng.integers(1, 12))}S")
        parts.append(f"{int(rng.integers(1, 80))}M")
        for _ in range(int(rng.integers(0, 3))):
            kind = rng.choice(["I", "D", "N", "P"])
            parts.append(f"{int(rng.integers(1, 30))}{kind}")
            parts.append(f"{int(rng.integers(1, 60))}M")
        if rng.random() < 0.3:
            parts.append(f"{int(rng.integers(1, 12))}S")
        if rng.random() < 0.2:
            parts.append(f"{int(rng.integers(1, 9))}H")
        paired = rng.random() < 0.4
        flag = 0x1 if paired else 0x0
        rnext = tid if paired else -1
        nh = int(rng.integers(1, 4)) if rng.random() < 0.5 else None
        if nh is None:
            recs.append((f"q{i}", tid, pos, flag, "".join(parts), rnext))
        else:
            recs.append((f"q{i}", tid, pos, flag, "".join(parts), rnext,
                         nh))
    return recs


def test_cram_fuzz_random_records(tmp_path):
    """Randomized roundtrip: arbitrary CIGAR shapes, unmapped reads,
    mixed-tid (multi-ref) slices, random slice sizes and codecs must all
    reproduce the BAM path's columns exactly."""
    rng = np.random.default_rng(99)
    for trial in range(6):
        recs = _random_records(rng, int(rng.integers(1, 120)))
        bp = str(tmp_path / f"f{trial}.bam")
        cp = str(tmp_path / f"f{trial}.cram")
        bamio.write_bam(bp, _REFS, _LENS, recs)
        _, bc = bamio.read_bam(bp, native=False, drop_unmapped=False)
        cramio.write_cram(
            cp, _REFS, _LENS, recs,
            compression=str(rng.choice(["raw", "gzip", "rans"])),
            preserve_names=bool(rng.random() < 0.8),
            ap_delta=bool(rng.random() < 0.5),
            link_mates=bool(rng.random() < 0.5),
            records_per_slice=int(rng.integers(1, 40)))
        _, cc = cramio.read_cram(cp, drop_unmapped=False)
        assert len(cc) == len(bc), trial
        for f in ("tid", "pos", "flag", "rnext", "nh",
                  "cigar_ops", "cigar_lens", "cigar_offsets"):
            assert np.array_equal(getattr(cc, f), getattr(bc, f)), \
                (trial, f)
        # the vectorized decoder (io/cram_fast.py) must be exactly
        # equivalent to the per-record reference decoder
        _, slow = cramio.read_cram(cp, drop_unmapped=False, fast=False)
        assert list(cc.qnames) == list(slow.qnames), trial
        for f in ("tid", "pos", "flag", "rnext", "nh",
                  "cigar_ops", "cigar_lens", "cigar_offsets"):
            assert np.array_equal(getattr(cc, f), getattr(slow, f)), \
                (trial, "fast-vs-slow", f)


def test_cram_region_streaming_matches_whole_file(tmp_path):
    """read_cram_region (seek-and-skip container streaming) must equal
    the whole-file decode filtered to the same tid, including the
    multi-ref boundary slices a (tid, pos)-sorted file produces."""
    rng = np.random.default_rng(17)
    recs = sorted(_random_records(rng, 150), key=lambda r: (r[1], r[2]))
    cp = str(tmp_path / "mc.cram")
    cramio.write_cram(cp, _REFS, _LENS, recs, records_per_slice=16)
    _, whole = cramio.read_cram(cp, drop_unmapped=False)
    for tid in (0, 1):
        region = cramio.read_cram_region(cp, tid, drop_unmapped=False)
        ref = cramio._filter_columns(whole, tid=tid, drop_unmapped=False)
        assert list(region.qnames) == list(ref.qnames)
        for f in ("tid", "pos", "flag", "rnext", "nh",
                  "cigar_ops", "cigar_lens", "cigar_offsets"):
            assert np.array_equal(getattr(region, f), getattr(ref, f)), \
                (tid, f)


def test_cram_head_qnames(tmp_path):
    recs = [(f"n{i}.{1 + i % 2}", 0, 10 * i, 0x1, "30M", 0, 1)
            for i in range(50)]
    cp = str(tmp_path / "h.cram")
    cramio.write_cram(cp, _REFS, _LENS, recs, records_per_slice=8)
    got = cramio.read_cram_head_qnames(cp, 10)
    assert got == [r[0] for r in recs[:10]]
    assert cramio.read_cram_head_qnames(cp, 999) == [r[0] for r in recs]


def test_sample_processor_cram_streaming_matches(tmp_path):
    """BamSampleProcessor(stream=True) on a .cram (per-chromosome
    container streaming, no index) must reproduce the whole-file-decode
    outputs exactly."""
    from degnorm_jax.io.gtf import process_annotation
    from degnorm_jax.io.overlap import overlap_structure
    from degnorm_jax.pipeline.sample import BamSampleProcessor

    rng = np.random.default_rng(31)
    genes = make_genes(rng, n_genes=5, overlap_fraction=0.3)
    gtf = str(tmp_path / "g.gtf")
    write_gtf(gtf, genes)
    cp = str(tmp_path / "s.cram")
    write_sample_cram(cp, genes, CHROM_LEN, seed=8, paired=True,
                      mean_reads_per_gene=60, degradation=0.2)
    exon_df = process_annotation(gtf)
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = {"chr1": overlap_structure(gene_df[gene_df.chr == "chr1"])}

    out = {}
    for stream in (False, True):
        proc = BamSampleProcessor(cp, stream=stream)
        assert proc.stream == stream and proc.paired
        out[stream] = proc.coverage_read_counts(ov, gene_df, exon_df)
    a, b = out[False]["chr1"], out[True]["chr1"]
    assert a.read_counts == b.read_counts
    if a.isolated_coverage is not None:
        assert np.array_equal(a.isolated_coverage, b.isolated_coverage)
    for g in a.overlap_coverage:
        assert np.array_equal(a.overlap_coverage[g],
                              b.overlap_coverage[g])


# ---------------------------------------------------------------------------
# pipeline integration
# ---------------------------------------------------------------------------

def test_sample_processor_cram_matches_bam(tmp_path):
    """BamSampleProcessor on a .cram must produce byte-identical coverage
    and read counts to the .bam of the same simulated reads."""
    from degnorm_jax.io.gtf import process_annotation
    from degnorm_jax.io.overlap import overlap_structure
    from degnorm_jax.pipeline.sample import BamSampleProcessor

    rng = np.random.default_rng(5)
    genes = make_genes(rng, n_genes=6, overlap_fraction=0.3)
    gtf = str(tmp_path / "g.gtf")
    write_gtf(gtf, genes)
    bp, cp = str(tmp_path / "s.bam"), str(tmp_path / "s.cram")
    write_sample_bam(bp, genes, CHROM_LEN, seed=21, paired=True,
                     mean_reads_per_gene=100, degradation=0.3)
    write_sample_cram(cp, genes, CHROM_LEN, seed=21, paired=True,
                      mean_reads_per_gene=100, degradation=0.3)

    exon_df = process_annotation(gtf)
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = {"chr1": overlap_structure(gene_df[gene_df.chr == "chr1"])}

    out = {}
    for path in (bp, cp):
        proc = BamSampleProcessor(path)
        assert proc.paired
        out[path] = proc.coverage_read_counts(ov, gene_df, exon_df)
    cb, cc = out[bp]["chr1"], out[cp]["chr1"]
    assert cb.read_counts == cc.read_counts
    if cb.isolated_coverage is not None:
        assert np.array_equal(cb.isolated_coverage, cc.isolated_coverage)
    assert set(cb.overlap_coverage) == set(cc.overlap_coverage)
    for g in cb.overlap_coverage:
        assert np.array_equal(cb.overlap_coverage[g],
                              cc.overlap_coverage[g])


def test_pipeline_cli_accepts_cram(tmp_path):
    """Full CLI run on .cram inputs (reference test_zzz_pipeline.py shape,
    with the format the reference cannot read)."""
    from degnorm_jax.cli import main

    rng = np.random.default_rng(42)
    genes = make_genes(rng, n_genes=6, overlap_fraction=0.2)
    gtf = str(tmp_path / "sim.gtf")
    write_gtf(gtf, genes)
    crams = []
    for i, deg in enumerate((0.0, 0.5)):
        cpath = str(tmp_path / f"sample{i}.cram")
        write_sample_cram(cpath, genes, CHROM_LEN, seed=100 + i,
                          mean_reads_per_gene=100, degradation=deg)
        crams.append(cpath)
    out_base = str(tmp_path / "out")
    os.makedirs(out_base)
    rc = main(["--bam-files", *crams, "-g", gtf, "-o", out_base,
               "--nmf-iter", "5", "--iter", "2"])
    assert rc == 0
    runs = [p for p in os.listdir(out_base) if p.startswith("degnorm_")]
    assert len(runs) == 1
    import pandas as pd
    di = pd.read_csv(os.path.join(out_base, runs[0],
                                  "degradation_index_scores.csv"))
    assert {"sample0", "sample1"} <= set(di.columns)
    vals = di[["sample0", "sample1"]].values
    assert np.isfinite(vals).all() and (vals >= 0).all()


# ---------------------------------------------------------------------------
# review regressions
# ---------------------------------------------------------------------------

def test_container_at_eof_sentinel_coordinate_not_dropped(tmp_path):
    """A data container whose alignment start happens to equal the EOF
    sentinel position (4,542,278) must still be decoded — only zero-record
    containers are skippable."""
    refs, lens = ["chrBig"], [10_000_000]
    recs = [("a", 0, cramio.EOF_START - 1, 0x0, "50M", -1, 1),
            ("b", 0, cramio.EOF_START + 100, 0x0, "50M", -1, 1)]
    cp = str(tmp_path / "eofpos.cram")
    cramio.write_cram(cp, refs, lens, recs)
    _, cc = cramio.read_cram(cp)
    assert list(cc.qnames) == ["a", "b"]
    region = cramio.read_cram_region(cp, 0)
    assert list(region.qnames) == ["a", "b"]
    assert cramio.read_cram_head_qnames(cp, 10) == ["a", "b"]


@pytest.mark.parametrize("preserve_names", [True, False])
def test_nf_chain_fast_matches_reference_decoder(tmp_path, preserve_names):
    """3+ same-qname records form an NF chain; the vectorized decoder must
    reproduce the per-record decoder's sequential link resolution (a chain
    middle keeps its own forward rnext, not the backlink)."""
    recs = [("chain", 0, 100, 0x1, "30M", 1, 1),
            ("chain", 1, 200, 0x1, "30M", 2, 1),
            ("chain", 2, 300, 0x1 | 0x10, "30M", 1, 1),
            ("solo", 0, 400, 0x0, "20M", -1, 1)]
    refs = ["c1", "c2", "c3"]
    lens = [10_000, 10_000, 10_000]
    cp = str(tmp_path / "chain.cram")
    cramio.write_cram(cp, refs, lens, recs, link_mates=True,
                      preserve_names=preserve_names)
    _, slow = cramio.read_cram(cp, drop_unmapped=False, fast=False)
    _, fastc = cramio.read_cram(cp, drop_unmapped=False, fast=True)
    for f in ("tid", "pos", "flag", "rnext", "nh",
              "cigar_ops", "cigar_lens", "cigar_offsets"):
        assert np.array_equal(getattr(fastc, f), getattr(slow, f)), f
    assert list(fastc.qnames) == list(slow.qnames)
    # sequential semantics: rnext = [tid(mate1), tid(mate2), tid(mate1), -1]
    assert list(slow.rnext) == [1, 2, 1, -1]
    # mate-reverse flag propagates backlink-ward from the reversed tail
    assert slow.flag[1] & 0x20
    if not preserve_names:
        # the whole chain shares the head leader's generated name
        assert fastc.qnames[0] == fastc.qnames[1] == fastc.qnames[2]
        assert fastc.qnames[3] != fastc.qnames[0]


def test_rans_normalization_skewed_many_rare_symbols():
    """200 rare symbols each bumped to freq 1 overshoot the 4096 budget;
    normalization must shave the excess off the common symbols instead of
    producing a negative frequency (and must stay a valid stream)."""
    rng = np.random.default_rng(3)
    rare = np.arange(200, dtype=np.uint8)
    common = rng.integers(200, 256, 16_184, dtype=np.uint8)
    data = bytes(np.concatenate([rare, common])[rng.permutation(16_384)])
    for order in (0, 1):
        assert rans.uncompress(rans.compress(data, order=order)) == data
    freqs = rans._normalize_freqs(np.bincount(np.frombuffer(data, np.uint8),
                                              minlength=256))
    assert int(freqs.sum()) == rans.TOTFREQ and int(freqs.min()) >= 0
    assert (freqs[np.bincount(np.frombuffer(data, np.uint8),
                              minlength=256) > 0] >= 1).all()


def test_compression_header_ap_default_is_delta():
    """CRAM 3.0 spec: absent preservation-map keys default to true — an
    omitted AP key means delta-encoded alignment positions."""
    data = bytearray()
    cramio.write_itf8(data, 0)      # preservation map byte size (redundant)
    cramio.write_itf8(data, 0)      # no preservation-map entries
    cramio.write_itf8(data, 0)      # ds map size
    cramio.write_itf8(data, 0)      # no data-series encodings
    cramio.write_itf8(data, 0)      # tag map size
    cramio.write_itf8(data, 0)      # no tag encodings
    ch = cramio.read_compression_header(bytes(data))
    assert ch.ap_delta is True and ch.rn_preserved is True and ch.rr is True


def test_read_cram_header_huge_sam_header(tmp_path):
    """Scaffold-level assemblies can push the SAM header container past
    4 MiB; read_cram_header must read it whole, not a fixed-size prefix."""
    n_refs = 130_000
    refs = [f"scaffold_{i:06d}_with_a_rather_long_name" for i in range(n_refs)]
    lens = [1000] * n_refs
    recs = [("r", 0, 10, 0x0, "20M", -1, 1)]
    cp = str(tmp_path / "huge.cram")
    cramio.write_cram(cp, refs, lens, recs)
    hdr = cramio.read_cram_header(cp)
    assert len(hdr.text.encode()) > (1 << 22)
    assert hdr.ref_names == refs and hdr.ref_lengths == lens


def test_cram_pair_hash_matches_native_bam(tmp_path):
    """The fast decoder fills the optional pairing columns (pair_hash /
    mate_code) from the raw name bytes so the native coverage kernel's
    paired path engages for CRAM input; values must equal the native BAM
    reader's on identical records."""
    from degnorm_jax.io.native.build import load_library
    if load_library() is None:
        pytest.skip("native library unavailable")
    bp = str(tmp_path / "p.bam")
    bamio.write_bam(bp, _REFS, _LENS, _RECS)
    _, bc = bamio.read_bam(bp)                      # native: fills pairing
    assert bc.pair_hash is not None
    cp = str(tmp_path / "p.cram")
    cramio.write_cram(cp, _REFS, _LENS, _RECS, records_per_slice=3)
    _, cc = cramio.read_cram(cp, fast=True)
    assert cc.pair_hash is not None and cc.mate_code is not None
    assert np.array_equal(cc.pair_hash, bc.pair_hash)
    assert np.array_equal(cc.mate_code, bc.mate_code)
    # mate codes reflect the '.1'/'.2' suffixes of _RECS
    assert list(cc.mate_code[:2]) == [1, 2]
    # paired mates share a hash; dotless names all hash the empty prefix
    # (reference reads.py:258 split semantics), distinct from the pair
    assert cc.pair_hash[0] == cc.pair_hash[1]
    dotless = [i for i, q in enumerate(cc.qnames) if "." not in q]
    assert len({int(cc.pair_hash[i]) for i in dotless}) == 1
    assert cc.pair_hash[dotless[0]] != cc.pair_hash[0]


def test_cram_paired_coverage_native_matches_numpy(tmp_path):
    """Paired CRAM input routes through the C++ coverage kernel (enabled
    by the decoder-filled pair_hash column) and matches the numpy path."""
    import pandas as pd
    from degnorm_jax.io.coverage import chromosome_coverage_read_counts
    from degnorm_jax.io.coverage_native import chromosome_coverage_native
    from degnorm_jax.io.native.build import load_library
    if load_library() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    recs = []
    for i in range(150):
        p = int(rng.integers(0, 8000))
        recs.append((f"t{i}.1", 0, p, 0x1 | 0x40, "50M", 0, 1))
        recs.append((f"t{i}.2", 0, p + 120, 0x1 | 0x80, "50M", 0, 1))
    recs.sort(key=lambda r: r[2])
    cp = str(tmp_path / "p.cram")
    cramio.write_cram(cp, ["chr1"], [20_000], recs, records_per_slice=64)
    _, cc = cramio.read_cram(cp)
    assert cc.pair_hash is not None
    gene_df = pd.DataFrame({"chr": ["chr1"], "gene": ["g0"],
                            "gene_start": [1], "gene_end": [20_000]})
    exon_df = pd.DataFrame({"chr": ["chr1"], "gene": ["g0"],
                            "start": [1], "end": [20_000]})
    ov = {"overlap_genes": [], "isolated_genes": ["g0"]}
    nat = chromosome_coverage_native(cc, "chr1", 20_000, gene_df, exon_df,
                                     ov, paired=True)
    assert nat is not None, "paired CRAM must engage the native kernel"
    py = chromosome_coverage_read_counts(cc, "chr1", 20_000, gene_df,
                                         exon_df, ov, paired=True,
                                         native=False)
    assert nat.read_counts == py.read_counts == {"g0": 150}

    def dense(c):
        x = c.isolated_coverage
        return np.asarray(x.todense()).ravel() if hasattr(x, "todense") \
            else np.asarray(x)
    assert np.array_equal(dense(nat), dense(py))
