"""Unit tests mirroring the reference's own suite (SURVEY.md §4):
CIGAR segment bounds (tests/test_reads.py:151-189), GTF loader column
contract (tests/test_loaders.py), bucket packing invariants."""
import numpy as np
import pytest

from degnorm_jax.data.buckets import pack_buckets
from degnorm_jax.io import bam as bamio
from degnorm_jax.io.coverage import read_match_segments
from degnorm_jax.io.gtf import load_exons
from degnorm_jax.io.simulate import SimGene, write_gtf


def cols_for(cigar, pos):
    ops, lens = [], []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            ops.append("MIDNSHP=X".index(ch))
            lens.append(int(num))
            num = ""
    return bamio.ReadColumns(
        qnames=np.array(["r"], object), tid=np.array([0], np.int32),
        pos=np.array([pos], np.int32), flag=np.array([0], np.uint16),
        rnext=np.array([-1], np.int32), nh=np.array([0], np.int32),
        cigar_ops=np.array(ops, np.int8), cigar_lens=np.array(lens, np.int32),
        cigar_offsets=np.array([0, len(ops)], np.int64))


def bounds_compat(cigar, pos):
    _, s, e, _ = read_match_segments(cols_for(cigar, pos),
                                     compat="reference")
    return [v for pair in zip(s, e) for v in pair]


def test_cigar_full_match():
    # reference tests/test_reads.py: '100M' at 0 -> [0, 99]
    assert bounds_compat("100M", 0) == [0, 99]


def test_cigar_mixed_ops():
    # '13M10X10D100M' at 100 -> [100, 112, 133, 232] (reference semantics:
    # every op consumes reference bases)
    assert bounds_compat("13M10X10D100M", 100) == [100, 112, 133, 232]


def test_cigar_leading_hard_clip():
    # '11H50M10D5M' at 100 -> [111, 160, 171, 175]
    assert bounds_compat("11H50M10D5M", 100) == [111, 160, 171, 175]


def test_cigar_strict_mode_differs():
    # strict SAM semantics: H consumes nothing, X is a match
    _, s, e, _ = read_match_segments(cols_for("11H50M10D5M", 100),
                                     compat="strict")
    assert list(s) == [100, 160] and list(e) == [149, 164]
    _, s, e, _ = read_match_segments(cols_for("13M10X10D100M", 100),
                                     compat="strict")
    # M and X merge-adjacent? they are separate ops -> separate segments
    assert list(s) == [100, 113, 133]


def test_end_pos_includes_all_ops():
    # end_pos = pos + sum of ALL cigar lengths (reference reads.py:404-405)
    _, _, _, end = read_match_segments(cols_for("25M100N25M3S", 10),
                                       compat="reference")
    assert end[0] == 10 + 25 + 100 + 25 + 3


def test_gtf_loader_contract(tmp_path):
    genes = [SimGene("g1", "chr1", [(100, 200), (300, 400)]),
             SimGene("g2", "chr2", [(50, 150)])]
    path = str(tmp_path / "x.gtf")
    write_gtf(path, genes)
    df = load_exons(path)
    assert list(df.columns) == ["chr", "start", "end", "gene"]
    assert set(df.gene) == {"g1", "g2"}
    assert df[df.gene == "g1"].shape[0] == 2
    with pytest.raises(ValueError):
        load_exons(path, chroms=["chrX"])
    with pytest.raises(ValueError):
        load_exons(str(tmp_path / "nope.bam"))


def test_gtf_gene_id_fallback(tmp_path):
    p = tmp_path / "y.gtf"
    p.write_text('chr1\tsim\texon\t10\t99\t.\t+\t.\tgene_id "ABC";\n')
    df = load_exons(str(p))
    assert df.gene.tolist() == ["ABC"]


def test_pack_buckets_invariants():
    rng = np.random.default_rng(0)
    mats = [np.abs(rng.standard_normal((3, L))) for L in
            (100, 260, 1000, 5000, 70000)]
    buckets = pack_buckets(mats, bucket_widths=(256, 1024, 4096),
                           pad_genes_to=4, dtype=np.float64)
    seen = set()
    for b in buckets:
        assert b.F.shape[0] % 4 == 0
        for slot, gi in enumerate(b.gene_indices):
            if gi < 0:
                assert not b.F[slot].any()
                continue
            seen.add(gi)
            L = mats[gi].shape[1]
            assert b.lengths[slot] == L and L <= b.width
            np.testing.assert_array_equal(b.F[slot, :, :L], mats[gi])
            assert not b.F[slot, :, L:].any()
    assert seen == set(range(len(mats)))
    # the 70000-length gene gets an ad-hoc 128-aligned bucket
    assert any(b.width == ((70000 + 127) // 128) * 128 for b in buckets)


def test_compat_rejects_no_match_cigar():
    """Reference parity: a CIGAR with no literal 'M' op raises in compat
    mode (reads.py:62-64); strict mode treats '='/'X' as match."""
    import numpy as np
    import pytest
    from degnorm_jax.io.bam import ReadColumns
    from degnorm_jax.io.coverage import (check_compat_match_regions,
                                         read_match_segments)
    cols = ReadColumns(
        qnames=np.array(["r0", "r1"], dtype=object),
        tid=np.zeros(2, np.int32),
        pos=np.array([10, 50], np.int32),
        flag=np.zeros(2, np.uint16),
        rnext=np.full(2, -1, np.int32),
        nh=np.ones(2, np.int32),
        # r0: 30M; r1: 30= (no literal M)
        cigar_ops=np.array([0, 7], np.int8),
        cigar_lens=np.array([30, 30], np.int32),
        cigar_offsets=np.array([0, 1, 2], np.int64),
    )
    with pytest.raises(ValueError, match="no matching region"):
        check_compat_match_regions(cols)
    # strict mode: '=' is a match op, both reads produce segments
    seg_read, s, e, _ = read_match_segments(cols, compat="strict")
    assert set(seg_read.tolist()) == {0, 1}
