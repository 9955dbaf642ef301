"""Adversarial CRAM 3.0 fixtures — container shapes htslib is entitled to
emit but the in-repo writer never does (VERDICT r3 item 7):

  * multi-slice data containers (several slices sharing one compression
    header, each with its own external block set);
  * core-bitstream encodings on the positional/int series: BETA absolute
    positions, GAMMA lengths, non-constant canonical HUFFMAN flags,
    BYTE_ARRAY_LEN read names with a GAMMA length encoding;
  * slices with an embedded-reference block (embedded_ref_id >= 0) that a
    reference-free decoder must skip.

Each forged file is decoded by BOTH decode paths — the vectorized fast
decoder (io/cram_fast.py, which must cleanly fall back on unsupported
profiles) and the per-record reference decoder — and compared against
the in-repo writer's output for the SAME records.  Corrupting any body
byte must surface as a checksum/structure error, never silent data.

The forge builds containers from io/cram.py's own primitives (blocks,
maps, itf8) but chooses encodings the writer does not, exercising
decoder paths that in-repo roundtrips cannot reach (htslib is not
installable in this environment — tests/test_cram.py documents the
interop caveat this file narrows).
"""
import struct
import zlib

import numpy as np
import pytest

from degnorm_jax.io import cram as C


# ---------------------------------------------------------------------------
# forging helpers
# ---------------------------------------------------------------------------

class _BitW(C.BitWriter):
    def beta(self, value, offset, nbits):
        self.write(value + offset, nbits)

    def gamma(self, value, offset):
        u = value + offset
        assert u >= 1
        n = u.bit_length()
        self.write(0, n - 1)
        self.write(u, n)

    def huff(self, value, table):
        ln, code = table[value]
        self.write(code, ln)


def _huff_table(syms, lens):
    """Canonical code assignment — must mirror Encoding._build_huffman."""
    order = sorted(range(len(syms)), key=lambda i: (lens[i], syms[i]))
    code, prev = 0, 0
    table = {}
    for i in order:
        code <<= (lens[i] - prev)
        prev = lens[i]
        table[syms[i]] = (lens[i], code)
        code += 1
    return table


def _p_beta(offset, nbits):
    p = bytearray(); C.write_itf8(p, offset); C.write_itf8(p, nbits)
    return C.E_BETA, bytes(p)


def _p_gamma(offset):
    p = bytearray(); C.write_itf8(p, offset)
    return C.E_GAMMA, bytes(p)


def _p_huff(syms, lens):
    p = bytearray()
    C.write_itf8(p, len(syms))
    for s in syms:
        C.write_itf8(p, s)
    C.write_itf8(p, len(lens))
    for l in lens:
        C.write_itf8(p, l)
    return C.E_HUFFMAN, bytes(p)


def _records(n=40, seed=3):
    """Simple mapped single-end records (the io/bam.py tuple shape)."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(100, 5000, n))
    recs = []
    for i in range(n):
        flag = 0 if rng.random() < 0.8 else 16
        nh = 2 if rng.random() < 0.2 else 1
        recs.append((f"q{i:04d}", 0, int(pos[i]), flag, "50M", -1, nh))
    return recs


def _sam_header_container(ref_names, ref_lengths):
    out = bytearray()
    out += C.CRAM_MAGIC + bytes([3, 0]) + b"adversary".ljust(20, b"\x00")
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ref_names, ref_lengths))
    tb = text.encode()
    blocks = bytearray()
    C.write_block(blocks, C.Block(C.M_RAW, C.CT_FILE_HEADER, 0,
                                  struct.pack("<i", len(tb)) + tb))
    C.write_container_header(out, C.ContainerHeader(
        len(blocks), 0, 0, 0, 0, 0, 0, 1, [0]))
    out += blocks
    return out


def _eof_container():
    out = bytearray()
    blocks = bytearray()
    C.write_block(blocks, C.Block(
        C.M_RAW, C.CT_COMPRESSION_HEADER, 0,
        bytes(C._map_bytes([]) + C._map_bytes([]) + C._map_bytes([]))))
    C.write_container_header(out, C.ContainerHeader(
        len(blocks), -1, C.EOF_START, 0, 0, 0, 0, 1, [0]))
    out += blocks
    return out


# external content ids (arbitrary but distinct)
_CID = {"BF": 1, "CF": 2, "RL": 3, "AP": 4, "RG": 5, "RN": 6, "MF": 7,
        "NS": 8, "NP": 9, "TS": 10, "TL": 11, "FN": 12, "MQ": 13,
        "RNLEN": 14, "TAGL": 15, "TAGV": 16}
_EMBED_CID = 99


def _forge_core_profile(recs, ref_len, *, embedded_ref=False):
    """One slice whose int series ride the CORE bit stream: BETA absolute
    AP, GAMMA RL, canonical (non-const) HUFFMAN BF, huffman-const
    CF/RG/TL/FN, BETA MQ; RN as BYTE_ARRAY_LEN(GAMMA len, EXTERNAL
    values).  NS/NP/TS/MF stay external.  Returns the container bytes."""
    bf_syms = sorted({int(r[3]) | 0x8 * 0 for r in recs} | {0, 16})
    bf_lens = ([1, 1] if len(bf_syms) == 2
               else [max(1, len(bf_syms).bit_length())] * len(bf_syms))
    # canonical huffman needs Kraft sum <= 1; use fixed-width codes
    w = max(1, (len(bf_syms) - 1).bit_length())
    bf_lens = [w] * len(bf_syms)
    bf_tab = _huff_table(bf_syms, bf_lens)

    nbits_ap = max(8, int(ref_len + 1).bit_length())
    core = _BitW()
    ext = {k: bytearray() for k in ("RN", "MF", "NS", "NP", "TS",
                                    "TAGL", "TAGV")}

    for qname, tid, pos0, flag, cigar, rnext, nh in recs:
        core.huff(int(flag), bf_tab)                    # BF
        # CF: huffman-const DETACHED — no bits emitted
        core.gamma(50, 1)                               # RL (gamma, off 1)
        core.beta(int(pos0) + 1, 0, nbits_ap)           # AP absolute
        # RG: huffman-const -1 — no bits
        core.gamma(len(qname), 0)                       # RN length (gamma)
        ext["RN"] += qname.encode()
        C.write_itf8(ext["MF"], 0)
        C.write_itf8(ext["NS"], int(rnext))
        C.write_itf8(ext["NP"], 0)
        C.write_itf8(ext["TS"], 0)
        # TL: const 1 -> NH:i tag for every record
        ext["TAGL"] += bytes([4])
        ext["TAGV"] += struct.pack("<i", int(nh))
        # FN: const 0 (pure 50M) ; MQ beta 8 bits
        core.beta(60, 0, 8)                             # MQ

    td_raw = b"\x00" + b"NHi" + b"\x00"     # line0: no tags; line1: NH:i
    pres = [b"RN" + bytes([1]), b"AP" + bytes([0]), b"RR" + bytes([0]),
            b"TD" + bytes([len(td_raw)]) + td_raw]
    ds = []

    def add(key, enc):
        e = bytearray(key.encode())
        C._write_encoding(e, *enc)
        ds.append(bytes(e))

    add("BF", _p_huff(bf_syms, bf_lens))
    add("CF", C.enc_huffman_const(C.CF_DETACHED))
    add("RL", _p_gamma(1))
    add("AP", _p_beta(0, nbits_ap))
    add("RG", C.enc_huffman_const(-1))
    add("RN", C.enc_byte_array_len(_p_gamma(0), C.enc_external(_CID["RN"])))
    add("MF", C.enc_external(_CID["MF"]))
    add("NS", C.enc_external(_CID["NS"]))
    add("NP", C.enc_external(_CID["NP"]))
    add("TS", C.enc_external(_CID["TS"]))
    add("TL", C.enc_huffman_const(1))
    add("FN", C.enc_huffman_const(0))
    add("MQ", _p_beta(0, 8))
    tag_entries = []
    key = (ord("N") << 16) | (ord("H") << 8) | ord("i")
    e = bytearray()
    C.write_itf8(e, key)
    C._write_encoding(e, *C.enc_byte_array_len(
        C.enc_external(_CID["TAGL"]), C.enc_external(_CID["TAGV"])))
    tag_entries.append(bytes(e))
    comp = C._map_bytes(pres) + C._map_bytes(ds) + C._map_bytes(tag_entries)

    positions = [int(r[2]) + 1 for r in recs]
    start = min(positions)
    span = max(positions) + 1 - start
    used = [("RN", _CID["RN"]), ("MF", _CID["MF"]), ("NS", _CID["NS"]),
            ("NP", _CID["NP"]), ("TS", _CID["TS"]),
            ("TAGL", _CID["TAGL"]), ("TAGV", _CID["TAGV"])]
    content_ids = [cid for _, cid in used]
    emb = -1
    if embedded_ref:
        emb = _EMBED_CID
        content_ids = content_ids + [_EMBED_CID]

    sh = bytearray()
    C.write_itf8(sh, 0)                    # ref_id
    C.write_itf8(sh, start)
    C.write_itf8(sh, span)
    C.write_itf8(sh, len(recs))
    C.write_ltf8(sh, 0)                    # counter
    C.write_itf8(sh, 1 + len(content_ids))
    C.write_itf8(sh, len(content_ids))
    for cid in content_ids:
        C.write_itf8(sh, cid)
    C.write_itf8(sh, emb)
    sh += b"\x00" * 16

    body = bytearray()
    C.write_block(body, C.Block(C.M_RAW, C.CT_COMPRESSION_HEADER, 0,
                                bytes(comp)))
    C.write_block(body, C.Block(C.M_RAW, C.CT_SLICE_HEADER, 0, bytes(sh)))
    C.write_block(body, C.Block(C.M_RAW, C.CT_CORE, 0, core.getvalue()))
    for k, cid in used:
        C.write_block(body, C.Block(C.M_RAW, C.CT_EXTERNAL, cid,
                                    bytes(ext[k])))
    if embedded_ref:
        C.write_block(body, C.Block(C.M_RAW, C.CT_EXTERNAL, _EMBED_CID,
                                    b"ACGT" * 64))

    out = bytearray()
    C.write_container_header(out, C.ContainerHeader(
        len(body), 0, start, span, len(recs), 0, 50 * len(recs),
        3 + len(content_ids), [0]))
    out += body
    return out


def _forge_multislice(recs, n_slices=3):
    """One data container holding several slices that share one
    compression header; every slice has its own external block set (the
    in-repo writer always emits one slice per container)."""
    per = (len(recs) + n_slices - 1) // n_slices
    chunks = [recs[i * per:(i + 1) * per] for i in range(n_slices)]
    chunks = [c for c in chunks if c]

    # all-external profile like the writer, built per slice
    keys_int = ["BF", "CF", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
                "TL", "FN", "MQ"]
    pres = [b"RN" + bytes([1]), b"AP" + bytes([0]), b"RR" + bytes([0]),
            b"TD" + b"\x01" + b"\x00"]
    ds = []

    def add(key, enc):
        e = bytearray(key.encode())
        C._write_encoding(e, *enc)
        ds.append(bytes(e))

    for k in keys_int:
        add(k, C.enc_external(_CID[k]))
    add("RN", C.enc_byte_array_stop(0, _CID["RN"]))
    comp = C._map_bytes(pres) + C._map_bytes(ds) + C._map_bytes([])

    body = bytearray()
    C.write_block(body, C.Block(C.M_RAW, C.CT_COMPRESSION_HEADER, 0,
                                bytes(comp)))
    landmarks = [0]
    total = 0
    counter = 0
    for chunk in chunks:
        landmarks.append(len(body))
        ext = {k: bytearray() for k in keys_int + ["RN"]}
        for qname, tid, pos0, flag, cigar, rnext, nh in chunk:
            C.write_itf8(ext["BF"], int(flag))
            C.write_itf8(ext["CF"], C.CF_DETACHED)
            C.write_itf8(ext["RL"], 50)
            C.write_itf8(ext["AP"], int(pos0) + 1)
            C.write_itf8(ext["RG"], -1)
            ext["RN"] += qname.encode() + b"\x00"
            C.write_itf8(ext["MF"], 0)
            C.write_itf8(ext["NS"], int(rnext))
            C.write_itf8(ext["NP"], 0)
            C.write_itf8(ext["TS"], 0)
            C.write_itf8(ext["TL"], 0)
            C.write_itf8(ext["FN"], 0)
            C.write_itf8(ext["MQ"], 60)
        used = [(k, _CID[k]) for k in keys_int + ["RN"]]
        positions = [int(r[2]) + 1 for r in chunk]
        start, span = min(positions), max(positions) + 1 - min(positions)
        sh = bytearray()
        C.write_itf8(sh, 0)
        C.write_itf8(sh, start)
        C.write_itf8(sh, span)
        C.write_itf8(sh, len(chunk))
        C.write_ltf8(sh, counter)
        C.write_itf8(sh, 1 + len(used))
        C.write_itf8(sh, len(used))
        for _, cid in used:
            C.write_itf8(sh, cid)
        C.write_itf8(sh, -1)
        sh += b"\x00" * 16
        C.write_block(body, C.Block(C.M_RAW, C.CT_SLICE_HEADER, 0,
                                    bytes(sh)))
        C.write_block(body, C.Block(C.M_RAW, C.CT_CORE, 0, b""))
        for k, cid in used:
            C.write_block(body, C.Block(C.M_RAW, C.CT_EXTERNAL, cid,
                                        bytes(ext[k])))
        total += len(chunk)
        counter += len(chunk)

    positions = [int(r[2]) + 1 for r in recs]
    out = bytearray()
    C.write_container_header(out, C.ContainerHeader(
        len(body), 0, min(positions),
        max(positions) + 1 - min(positions), total, 0, 50 * total,
        0, landmarks))
    out += body
    return out


def _forge_file(variant, recs, ref_len=10_000):
    out = _sam_header_container(["chr1"], [ref_len])
    if variant == "core":
        out += _forge_core_profile(recs, ref_len)
    elif variant == "embedded_ref":
        out += _forge_core_profile(recs, ref_len, embedded_ref=True)
    elif variant == "multislice":
        out += _forge_multislice(recs)
    else:
        raise AssertionError(variant)
    out += _eof_container()
    return bytes(out)


def _expected_columns(recs):
    """Ground truth via the in-repo writer + decoder roundtrip (itself
    pinned against io/bam.py in tests/test_cram.py)."""
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ref.cram")
        C.write_cram(p, ["chr1"], [10_000], recs, compression="raw")
        hdr, cols = C.read_cram(p, fast=False)
    return cols


def _assert_cols_equal(a, b):
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.flag, b.flag)
    np.testing.assert_array_equal(a.tid, b.tid)
    np.testing.assert_array_equal(a.nh, b.nh)
    assert list(np.asarray(a.qnames)) == list(np.asarray(b.qnames))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["core", "embedded_ref", "multislice"])
@pytest.mark.parametrize("fast", [False, True])
def test_forged_variants_decode(variant, fast):
    recs = _records()
    buf = _forge_file(variant, recs)
    hdr, cols = C.parse_cram_bytes(buf, fast=fast)
    # the multislice forge uses the no-tag dictionary (TL=0), so its
    # ground truth drops NH too
    want = _expected_columns([r[:6] for r in recs]
                             if variant == "multislice" else recs)
    _assert_cols_equal(cols, want)


def test_fast_decoder_falls_back_not_wrong():
    """The vectorized decoder must NOT claim the core-bitstream profile:
    decode_slice_fast returns None (fallback) rather than mis-decoding."""
    from degnorm_jax.io import cram_fast
    calls = {"n": 0, "none": 0}
    orig = cram_fast.decode_slice_fast

    def spy(*a, **k):
        calls["n"] += 1
        r = orig(*a, **k)
        if r is None:
            calls["none"] += 1
        return r

    recs = _records()
    buf = _forge_file("core", recs)
    cram_fast_decode = spy
    import unittest.mock as mock
    with mock.patch.object(cram_fast, "decode_slice_fast", spy):
        C.parse_cram_bytes(buf, fast=True)
    assert calls["n"] >= 1 and calls["none"] == calls["n"]


def test_multislice_per_slice_external_blocks_isolated():
    """External streams must reset per slice: a stale _Ext offset from
    slice 1 leaking into slice 2 would shift every field."""
    recs = _records(n=61, seed=9)       # uneven split across 3 slices
    buf = _forge_file("multislice", recs)
    _, cols = C.parse_cram_bytes(buf, fast=False)
    want = _expected_columns([r[:6] for r in recs])   # no-tag dictionary
    _assert_cols_equal(cols, want)


@pytest.mark.parametrize("variant", ["core", "multislice"])
def test_corruption_never_silent(variant):
    """Flipping any sampled body byte must raise (CRC/structure), or — if
    it decodes — the checksum caught case dominates; silent wrong data on
    a CRC-covered byte is a failure."""
    recs = _records(n=20)
    buf = bytearray(_forge_file(variant, recs))
    want = _expected_columns([r[:6] for r in recs]
                             if variant == "multislice" else recs)
    # sample positions inside the data container's block bodies
    rng = np.random.default_rng(0)
    hdr_end = len(_sam_header_container(["chr1"], [10_000]))
    eof_len = len(_eof_container())
    body = range(hdr_end + 20, len(buf) - eof_len)
    flipped = 0
    silent_wrong = 0
    for pos in rng.choice(list(body), size=30, replace=False):
        mut = bytearray(buf)
        mut[pos] ^= 0xFF
        flipped += 1
        try:
            _, cols = C.parse_cram_bytes(bytes(mut), fast=False)
        except Exception:
            continue
        try:
            _assert_cols_equal(cols, want)
        except AssertionError:
            silent_wrong += 1
    assert flipped == 30
    assert silent_wrong == 0, (
        f"{silent_wrong} corrupted streams decoded to wrong data "
        "without an error")
