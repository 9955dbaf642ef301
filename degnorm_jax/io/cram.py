"""CRAM 3.0 alignment-file reading and writing, dependency-free.

The reference accepts only .bam input through pysam (``loaders.py:44-70``,
``utils.py:417-421``); CRAM is the dominant archival format in the
ecosystem, so this module extends the io/ stack with it (ROADMAP item 5).
Like io/bam.py, it decodes straight into the columnar ``ReadColumns``
shape the vectorized coverage builder consumes.

Design notes:

- DegNorm needs only qname / flags / tid / pos / CIGAR / NH / rnext —
  **none of which require the reference FASTA**.  CIGAR is reconstructed
  from read features + read length, so real-world CRAMs decode here
  without any reference, embedded or external (base sequences are
  consumed from their byte streams and discarded).
- Codecs: raw, gzip/zlib, bzip2, lzma via the stdlib; rANS 4x8 via
  io/rans.py.  CRAM 3.1 codecs (rans4x16, adaptive arithmetic, fqzcomp,
  name tokenizer) are rejected with a clear error.
- Encodings: EXTERNAL, HUFFMAN (canonical, incl. the 0-bit constant
  form), BYTE_ARRAY_LEN, BYTE_ARRAY_STOP, BETA, GAMMA — the set htslib
  emits.  GOLOMB/GOLOMB_RICE/SUBEXP are not implemented (no known writer
  uses them).
- The writer exists to synthesize test fixtures (pysam/htslib are not
  installable here — SURVEY.md §4's stripped-blob situation all over
  again) and writes spec-shaped containers: EXTERNAL/HUFFMAN-const
  series encodings, BYTE_ARRAY_STOP names, BYTE_ARRAY_LEN tags,
  per-block CRC32s, and a structural EOF container.
- CIGAR ops '=' and 'X' canonicalize to 'M' through CRAM (the format
  only distinguishes them via reference comparison at decode time).
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from degnorm_jax.io import rans
from degnorm_jax.io.bam import (BamHeader, ReadColumns, _OP_INDEX,
                                subset_columns)

CRAM_MAGIC = b"CRAM"
EOF_START = 4_542_278            # 'EOF' little-endian-ish sentinel position

# block compression methods
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4
_31_ONLY = {5: "rans4x16", 6: "adaptive arithmetic",
            7: "fqzcomp", 8: "name tokenizer"}

# block content types
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5

# encoding codec ids
E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA = 4, 5, 6
E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = 7, 8, 9

# CF compression bit flags
CF_QS_PRESERVED, CF_DETACHED, CF_MATE_DOWNSTREAM, CF_NO_SEQ = 1, 2, 4, 8

FLAG_PAIRED, FLAG_UNMAPPED = 0x1, 0x4
FLAG_MATE_UNMAPPED, FLAG_REVERSE, FLAG_MATE_REVERSE = 0x8, 0x10, 0x20

_Q_CONSUMES = frozenset("MIS=X")   # cigar ops consuming query bases


# ---------------------------------------------------------------------------
# ITF8 / LTF8 varints
# ---------------------------------------------------------------------------

def write_itf8(out: bytearray, v: int) -> None:
    v &= 0xFFFFFFFF
    if v < 0x80:
        out.append(v)
    elif v < 0x4000:
        out += bytes([0x80 | (v >> 8), v & 0xFF])
    elif v < 0x200000:
        out += bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    elif v < 0x10000000:
        out += bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    else:
        out += bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                      (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(buf, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    if b0 < 0x80:
        v, off = b0, off + 1
    elif b0 < 0xC0:
        v = ((b0 & 0x3F) << 8) | buf[off + 1]
        off += 2
    elif b0 < 0xE0:
        v = ((b0 & 0x1F) << 16) | (buf[off + 1] << 8) | buf[off + 2]
        off += 3
    elif b0 < 0xF0:
        v = ((b0 & 0x0F) << 24) | (buf[off + 1] << 16) \
            | (buf[off + 2] << 8) | buf[off + 3]
        off += 4
    else:
        v = ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) \
            | (buf[off + 2] << 12) | (buf[off + 3] << 4) \
            | (buf[off + 4] & 0x0F)
        off += 5
    if v >= 1 << 31:
        v -= 1 << 32
    return v, off


def write_ltf8(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    for n, (tag, bits) in enumerate(
            [(0x00, 7), (0x80, 14), (0xC0, 21), (0xE0, 28),
             (0xF0, 35), (0xF8, 42), (0xFC, 49), (0xFE, 56), (0xFF, 64)]):
        if v < (1 << bits):
            if n == 8:
                out.append(0xFF)
                out += v.to_bytes(8, "big")
            else:
                out.append(tag | (v >> (8 * n)))
                out += (v & ((1 << (8 * n)) - 1)).to_bytes(n, "big")
            return


def read_ltf8(buf, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    extra = 0
    while extra < 8 and (b0 << extra) & 0x80:
        extra += 1
    if extra < 8:
        v = b0 & (0x7F >> extra)
    else:
        v = 0
    for i in range(extra):
        v = (v << 8) | buf[off + 1 + i]
    if v >= 1 << 63:
        v -= 1 << 64
    return v, off + 1 + extra


# ---------------------------------------------------------------------------
# blocks and containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes                   # uncompressed


def _compress_block(data: bytes, method: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        import gzip
        return gzip.compress(data, compresslevel=6, mtime=0)
    if method == M_RANS:
        return rans.compress(data, order=1 if len(data) >= 64 else 0)
    raise ValueError(f"writer does not emit compression method {method}")


def _uncompress_block(data: bytes, method: int, out_sz: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return zlib.decompress(data, 47)      # auto gzip/zlib headers
    if method == M_BZIP2:
        import bz2
        return bz2.decompress(data)
    if method == M_LZMA:
        import lzma
        return lzma.decompress(data)
    if method == M_RANS:
        return rans.uncompress(data)
    if method in _31_ONLY:
        raise ValueError(
            f"block uses the CRAM 3.1 codec '{_31_ONLY[method]}' "
            f"(method {method}); only CRAM 3.0 codecs are supported")
    raise ValueError(f"unknown block compression method {method}")


def write_block(out: bytearray, blk: Block, method: int = M_RAW) -> None:
    if blk.method != M_RAW:
        method = blk.method
    comp = _compress_block(blk.data, method)
    if len(comp) >= len(blk.data):           # store incompressible raw
        method, comp = M_RAW, blk.data
    hdr = bytearray([method, blk.content_type])
    write_itf8(hdr, blk.content_id)
    write_itf8(hdr, len(comp))
    write_itf8(hdr, len(blk.data))
    body = bytes(hdr) + comp
    out += body
    out += struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def read_block(buf, off: int, *, verify_crc: bool = True
               ) -> Tuple[Block, int]:
    start = off
    method, ctype = buf[off], buf[off + 1]
    off += 2
    cid, off = read_itf8(buf, off)
    comp_sz, off = read_itf8(buf, off)
    raw_sz, off = read_itf8(buf, off)
    comp = bytes(buf[off:off + comp_sz])
    off += comp_sz
    crc = struct.unpack_from("<I", buf, off)[0]
    if verify_crc and zlib.crc32(bytes(buf[start:off])) & 0xFFFFFFFF != crc:
        raise ValueError("CRAM block CRC32 mismatch")
    off += 4
    data = _uncompress_block(comp, method, raw_sz)
    if len(data) != raw_sz:
        raise ValueError("CRAM block decompressed to an unexpected size")
    return Block(method, ctype, cid, data), off


@dataclasses.dataclass
class ContainerHeader:
    length: int                   # byte length of the blocks section
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    bases: int
    n_blocks: int
    landmarks: List[int]


def write_container_header(out: bytearray, h: ContainerHeader) -> None:
    body = bytearray()
    write_itf8(body, h.ref_id)
    write_itf8(body, h.start)
    write_itf8(body, h.span)
    write_itf8(body, h.n_records)
    write_ltf8(body, h.counter)
    write_ltf8(body, h.bases)
    write_itf8(body, h.n_blocks)
    write_itf8(body, len(h.landmarks))
    for lm in h.landmarks:
        write_itf8(body, lm)
    hdr = struct.pack("<i", h.length) + bytes(body)
    out += hdr
    out += struct.pack("<I", zlib.crc32(hdr) & 0xFFFFFFFF)


def read_container_header(buf, off: int) -> Tuple[ContainerHeader, int]:
    length = struct.unpack_from("<i", buf, off)[0]
    off += 4
    ref_id, off = read_itf8(buf, off)
    start, off = read_itf8(buf, off)
    span, off = read_itf8(buf, off)
    n_records, off = read_itf8(buf, off)
    counter, off = read_ltf8(buf, off)
    bases, off = read_ltf8(buf, off)
    n_blocks, off = read_itf8(buf, off)
    n_lm, off = read_itf8(buf, off)
    landmarks = []
    for _ in range(n_lm):
        lm, off = read_itf8(buf, off)
        landmarks.append(lm)
    off += 4                      # header CRC32 (not validated: the exact
    #                               coverage range differs across writers)
    return ContainerHeader(length, ref_id, start, span, n_records,
                           counter, bases, n_blocks, landmarks), off


# ---------------------------------------------------------------------------
# core-block bit IO
# ---------------------------------------------------------------------------

class BitReader:
    """MSB-first bit reader over the core block."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0              # bit position

    def read(self, nbits: int) -> int:
        v = 0
        p = self.pos
        data = self.data
        for _ in range(nbits):
            byte = data[p >> 3]
            v = (v << 1) | ((byte >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.nbits = 0

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            if self.nbits % 8 == 0:
                self.buf.append(0)
            if (value >> i) & 1:
                self.buf[-1] |= 1 << (7 - (self.nbits % 8))
            self.nbits += 1

    def getvalue(self) -> bytes:
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

class _Ext:
    """Cursor over one external block's bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("external block over-read")
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def itf8(self) -> int:
        v, self.off = read_itf8(self.data, self.off)
        return v

    def until(self, stop: int) -> bytes:
        i = self.data.index(stop, self.off)
        b = self.data[self.off:i]
        self.off = i + 1
        return b


class Encoding:
    """One data-series decoder; reads ints or byte arrays from the core
    bit stream and/or external blocks (CRAM 3.0 §13)."""

    def __init__(self, codec: int, params: bytes):
        self.codec = codec
        p = 0
        if codec == E_EXTERNAL:
            self.cid, p = read_itf8(params, p)
        elif codec == E_HUFFMAN:
            n, p = read_itf8(params, p)
            syms = []
            for _ in range(n):
                v, p = read_itf8(params, p)
                syms.append(v)
            n2, p = read_itf8(params, p)
            lens = []
            for _ in range(n2):
                v, p = read_itf8(params, p)
                lens.append(v)
            self._build_huffman(syms, lens)
        elif codec == E_BYTE_ARRAY_LEN:
            cid_, plen, p = _read_nested_encoding(params, p)
            self.len_enc = Encoding(cid_, plen)
            cid_, pval, p = _read_nested_encoding(params, p)
            self.val_enc = Encoding(cid_, pval)
        elif codec == E_BYTE_ARRAY_STOP:
            self.stop = params[0]
            self.cid, p = read_itf8(params, 1)
        elif codec == E_BETA:
            self.offset, p = read_itf8(params, p)
            self.nbits, p = read_itf8(params, p)
        elif codec == E_GAMMA:
            self.offset, p = read_itf8(params, p)
        elif codec == E_NULL:
            pass
        else:
            names = {E_GOLOMB: "GOLOMB", E_SUBEXP: "SUBEXP",
                     E_GOLOMB_RICE: "GOLOMB_RICE"}
            raise ValueError(
                f"unsupported CRAM encoding codec "
                f"{names.get(codec, codec)}")

    def _build_huffman(self, syms: List[int], lens: List[int]) -> None:
        if len(lens) == 1 and lens[0] == 0:
            self.const = syms[0]
            self.table = None
            return
        self.const = None
        order = sorted(range(len(syms)), key=lambda i: (lens[i], syms[i]))
        code = 0
        prev_len = 0
        table: Dict[Tuple[int, int], int] = {}
        for i in order:
            code <<= (lens[i] - prev_len)
            prev_len = lens[i]
            table[(lens[i], code)] = syms[i]
            code += 1
        self.table = table
        self.max_len = max(lens)

    # -- int reads --------------------------------------------------------
    def read_int(self, core: BitReader, ext: Dict[int, _Ext]) -> int:
        c = self.codec
        if c == E_EXTERNAL:
            return ext[self.cid].itf8()
        if c == E_HUFFMAN:
            if self.const is not None:
                return self.const
            code, ln = 0, 0
            while ln <= self.max_len:
                code = (code << 1) | core.read(1)
                ln += 1
                v = self.table.get((ln, code))
                if v is not None:
                    return v
            raise ValueError("bad huffman code in core block")
        if c == E_BETA:
            return core.read(self.nbits) - self.offset
        if c == E_GAMMA:
            z = 0
            while core.read(1) == 0:
                z += 1
            v = 1
            for _ in range(z):
                v = (v << 1) | core.read(1)
            return v - self.offset
        raise ValueError(f"codec {c} cannot produce ints here")

    def read_byte(self, core: BitReader, ext: Dict[int, _Ext]) -> int:
        if self.codec == E_EXTERNAL:
            return ext[self.cid].take(1)[0]
        return self.read_int(core, ext)

    def read_bytes(self, n: int, core: BitReader,
                   ext: Dict[int, _Ext]) -> bytes:
        if n <= 0:
            return b""      # an all-empty series may have no block at all
        if self.codec == E_EXTERNAL:
            return ext[self.cid].take(n)
        return bytes(self.read_byte(core, ext) for _ in range(n))

    def read_array(self, core: BitReader, ext: Dict[int, _Ext]) -> bytes:
        if self.codec == E_BYTE_ARRAY_STOP:
            return ext[self.cid].until(self.stop)
        if self.codec == E_BYTE_ARRAY_LEN:
            n = self.len_enc.read_int(core, ext)
            return self.val_enc.read_bytes(n, core, ext)
        if self.codec == E_EXTERNAL:
            raise ValueError("EXTERNAL alone cannot delimit a byte array")
        raise ValueError(f"codec {self.codec} is not a byte-array encoding")


def _read_nested_encoding(buf: bytes, off: int) -> Tuple[int, bytes, int]:
    codec, off = read_itf8(buf, off)
    plen, off = read_itf8(buf, off)
    return codec, buf[off:off + plen], off + plen


def _write_encoding(out: bytearray, codec: int, params: bytes) -> None:
    write_itf8(out, codec)
    write_itf8(out, len(params))
    out += params


def enc_external(cid: int) -> Tuple[int, bytes]:
    p = bytearray()
    write_itf8(p, cid)
    return E_EXTERNAL, bytes(p)


def enc_huffman_const(value: int) -> Tuple[int, bytes]:
    p = bytearray()
    write_itf8(p, 1)
    write_itf8(p, value)
    write_itf8(p, 1)
    write_itf8(p, 0)
    return E_HUFFMAN, bytes(p)


def enc_byte_array_stop(stop: int, cid: int) -> Tuple[int, bytes]:
    p = bytearray([stop])
    write_itf8(p, cid)
    return E_BYTE_ARRAY_STOP, bytes(p)


def enc_byte_array_len(len_enc: Tuple[int, bytes],
                       val_enc: Tuple[int, bytes]) -> Tuple[int, bytes]:
    p = bytearray()
    _write_encoding(p, *len_enc)
    _write_encoding(p, *val_enc)
    return E_BYTE_ARRAY_LEN, bytes(p)


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionHeader:
    rn_preserved: bool
    ap_delta: bool
    rr: bool
    td: List[List[Tuple[str, str]]]        # tag lines: [(tag, type), ...]
    ds: Dict[str, Encoding]                # data-series encodings
    tags: Dict[int, Encoding]              # tag-id -> value encoding


def _parse_td(raw: bytes) -> List[List[Tuple[str, str]]]:
    lines = raw.split(b"\x00")
    out = []
    for ln in lines[:-1] if raw.endswith(b"\x00") else lines:
        entries = []
        for i in range(0, len(ln) - 2, 3):
            entries.append((ln[i:i + 2].decode("latin-1"),
                            chr(ln[i + 2])))
        out.append(entries)
    return out or [[]]


def read_compression_header(data: bytes) -> CompressionHeader:
    off = 0
    # spec defaults for absent preservation-map keys are all TRUE
    # (CRAM 3.0 §8.4) — notably AP: absent means delta-encoded positions.
    rn, ap, rr = True, True, True
    td: List[List[Tuple[str, str]]] = [[]]

    # preservation map
    _, off = read_itf8(data, off)          # size in bytes (redundant)
    n, off = read_itf8(data, off)
    for _ in range(n):
        key = data[off:off + 2]
        off += 2
        if key == b"RN":
            rn = bool(data[off]); off += 1
        elif key == b"AP":
            ap = bool(data[off]); off += 1
        elif key == b"RR":
            rr = bool(data[off]); off += 1
        elif key == b"SM":
            off += 5
        elif key == b"TD":
            ln, off = read_itf8(data, off)
            td = _parse_td(data[off:off + ln])
            off += ln
        else:
            raise ValueError(f"unknown preservation-map key {key!r}")

    # data series encodings
    _, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    ds: Dict[str, Encoding] = {}
    for _ in range(n):
        key = data[off:off + 2].decode("latin-1")
        off += 2
        codec, params, off = _read_nested_encoding(data, off)
        ds[key] = Encoding(codec, params)

    # tag encodings
    _, off = read_itf8(data, off)
    n, off = read_itf8(data, off)
    tags: Dict[int, Encoding] = {}
    for _ in range(n):
        tid_key, off = read_itf8(data, off)
        codec, params, off = _read_nested_encoding(data, off)
        tags[tid_key] = Encoding(codec, params)

    return CompressionHeader(rn, ap, rr, td, ds, tags)


def _map_bytes(entries: List[bytes]) -> bytes:
    """A CRAM map: size-in-bytes itf8, count itf8, entries."""
    body = bytearray()
    write_itf8(body, len(entries))
    for e in entries:
        body += e
    out = bytearray()
    write_itf8(out, len(body))
    out += body
    return bytes(out)


# ---------------------------------------------------------------------------
# slice decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_blocks: int
    content_ids: List[int]
    embedded_ref_id: int


def read_slice_header(data: bytes) -> SliceHeader:
    off = 0
    ref_id, off = read_itf8(data, off)
    start, off = read_itf8(data, off)
    span, off = read_itf8(data, off)
    n_records, off = read_itf8(data, off)
    counter, off = read_ltf8(data, off)
    n_blocks, off = read_itf8(data, off)
    n_ids, off = read_itf8(data, off)
    ids = []
    for _ in range(n_ids):
        v, off = read_itf8(data, off)
        ids.append(v)
    emb, off = read_itf8(data, off)
    # 16-byte md5 + optional tags follow; not needed
    return SliceHeader(ref_id, start, span, n_records, counter,
                       n_blocks, ids, emb)


@dataclasses.dataclass
class _Rec:
    bf: int
    tid: int
    pos: int          # 0-based
    rl: int
    qname: str
    rnext: int
    nh: int
    nf: int           # -1 unless mate-downstream
    cigar: List[Tuple[int, int]]        # (op, len) BAM codes


_TAG_SIZES = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}


def _decode_slice(ch: CompressionHeader, sh: SliceHeader,
                  core: BitReader, ext: Dict[int, _Ext],
                  name_prefix: str) -> List[_Rec]:
    ds = ch.ds

    def rint(key: str) -> int:
        return ds[key].read_int(core, ext)

    def rbyte(key: str) -> int:
        return ds[key].read_byte(core, ext)

    def rarray(key: str) -> bytes:
        return ds[key].read_array(core, ext)

    recs: List[_Rec] = []
    prev_ap = sh.start
    for idx in range(sh.n_records):
        bf = rint("BF")
        cf = rint("CF")
        tid = rint("RI") if sh.ref_id == -2 else sh.ref_id
        rl = rint("RL")
        ap = rint("AP")
        if ch.ap_delta:
            ap += prev_ap
            prev_ap = ap
        rint("RG")
        qname = ""
        if ch.rn_preserved:
            qname = rarray("RN").decode("latin-1")
        rnext, nf = -1, -1
        if cf & CF_DETACHED:
            mf = rint("MF")
            if not ch.rn_preserved:
                qname = rarray("RN").decode("latin-1")
            ns = rint("NS")
            rint("NP")
            rint("TS")
            rnext = ns
            if mf & 0x1:
                bf |= FLAG_MATE_REVERSE
            if mf & 0x2:
                bf |= FLAG_MATE_UNMAPPED
        elif cf & CF_MATE_DOWNSTREAM:
            nf = rint("NF")

        # tags
        nh = 0
        tl = rint("TL")
        for tag, typ in ch.td[tl]:
            key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            raw = ch.tags[key].read_array(core, ext)
            if tag == "NH" and typ in _TAG_FMT:
                nh = struct.unpack_from(_TAG_FMT[typ], raw, 0)[0]

        cigar: List[Tuple[int, int]] = []
        if not (bf & FLAG_UNMAPPED):
            cigar = _decode_features(ch, core, ext, rint, rbyte, rarray,
                                     rl, cf)
            rint("MQ")
            if cf & CF_QS_PRESERVED:
                ds["QS"].read_bytes(rl, core, ext)
        else:
            if not (cf & CF_NO_SEQ):
                ds["BA"].read_bytes(rl, core, ext)
            if cf & CF_QS_PRESERVED:
                ds["QS"].read_bytes(rl, core, ext)

        recs.append(_Rec(bf, tid, ap - 1, rl, qname, rnext, nh, nf, cigar))

    # resolve within-slice mate links (NF = records between this and mate)
    for i, r in enumerate(recs):
        if r.nf >= 0:
            j = i + r.nf + 1
            if j >= len(recs):
                raise ValueError("CRAM mate link escapes its slice")
            m = recs[j]
            r.rnext, m.rnext = m.tid, r.tid
            if m.bf & FLAG_REVERSE:
                r.bf |= FLAG_MATE_REVERSE
            if m.bf & FLAG_UNMAPPED:
                r.bf |= FLAG_MATE_UNMAPPED
            if r.bf & FLAG_REVERSE:
                m.bf |= FLAG_MATE_REVERSE
            if r.bf & FLAG_UNMAPPED:
                m.bf |= FLAG_MATE_UNMAPPED
            # names dropped at write time: mates must share one generated
            # name (the pipeline pairs reads by qname, reads.py:417-420)
            if not r.qname:
                r.qname = f"{name_prefix}{sh.counter + i}"
            if not m.qname:
                m.qname = r.qname
    for i, r in enumerate(recs):
        if not r.qname:
            r.qname = f"{name_prefix}{sh.counter + i}"
    return recs


def _decode_features(ch, core, ext, rint, rbyte, rarray, rl: int,
                     cf: int) -> List[Tuple[int, int]]:
    """Read the FN/FC/FP feature series and rebuild the BAM CIGAR
    (reference-free: gaps between features are M; '='/'X' runs surface
    as M, matching htslib's no-reference decode)."""
    ops: List[Tuple[int, int]] = []
    read_pos = 1                 # 1-based position within the read

    def add(opchar: str, ln: int) -> None:
        if ln <= 0:
            return
        code = _OP_INDEX[opchar]
        if ops and ops[-1][0] == code:
            ops[-1] = (code, ops[-1][1] + ln)
        else:
            ops.append((code, ln))

    fn = rint("FN")
    fpos = 0
    for _ in range(fn):
        fc = chr(rbyte("FC"))
        fpos += rint("FP")
        if fpos > read_pos:
            add("M", fpos - read_pos)
            read_pos = fpos
        if fc == "B":
            rbyte("BA"); rbyte("QS")
            add("M", 1); read_pos += 1
        elif fc == "X":
            rbyte("BS")
            add("M", 1); read_pos += 1
        elif fc == "D":
            add("D", rint("DL"))
        elif fc == "I":
            b = rarray("IN")
            add("I", len(b)); read_pos += len(b)
        elif fc == "i":
            rbyte("BA")
            add("I", 1); read_pos += 1
        elif fc == "S":
            b = rarray("SC")
            add("S", len(b)); read_pos += len(b)
        elif fc == "H":
            add("H", rint("HC"))
        elif fc == "P":
            add("P", rint("PD"))
        elif fc == "N":
            add("N", rint("RS"))
        elif fc == "b":
            b = rarray("BB")
            add("M", len(b)); read_pos += len(b)
        elif fc == "q":
            rarray("QQ")
        elif fc == "Q":
            rbyte("QS")
        else:
            raise ValueError(f"unknown CRAM feature code {fc!r}")
    if read_pos <= rl:
        add("M", rl - read_pos + 1)
    return ops


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _parse_sam_header(text: str) -> Tuple[List[str], List[int]]:
    names, lengths = [], []
    for line in text.splitlines():
        if line.startswith("@SQ"):
            nm, ln = None, None
            for field in line.split("\t")[1:]:
                if field.startswith("SN:"):
                    nm = field[3:]
                elif field.startswith("LN:"):
                    ln = int(field[3:])
            if nm is not None:
                names.append(nm)
                lengths.append(ln or 0)
    return names, lengths


def read_cram(path: str, *, tid: Optional[int] = None,
              drop_unmapped: bool = True,
              fast: Optional[bool] = None
              ) -> Tuple[BamHeader, ReadColumns]:
    """Decode a whole CRAM file into columnar arrays (read_bam's shape).

    ``fast``: use the vectorized slice decoder (io/cram_fast.py) where
    the encoding profile allows; None = auto (on unless
    DEGNORM_JAX_NO_NATIVE=1).  Semantics are identical either way."""
    with open(path, "rb") as f:
        buf = f.read()
    return parse_cram_bytes(buf, tid=tid, drop_unmapped=drop_unmapped,
                            fast=fast)


def read_cram_header(path: str) -> BamHeader:
    with open(path, "rb") as f:
        for ch, data_start in _walk_containers(f, include_first=True):
            f.seek(data_start)
            data = f.read(ch.length)   # exactly the SAM header container,
            if len(data) < ch.length:  # however large (100k-contig refs)
                raise ValueError("truncated CRAM header container")
            return _header_from_container(data)
    raise ValueError("CRAM file has no header container")


def _check_magic(buf: bytes) -> int:
    if buf[:4] != CRAM_MAGIC:
        raise ValueError("not a CRAM file (bad magic)")
    major = buf[4]
    if major != 3:
        raise ValueError(
            f"unsupported CRAM major version {major} (only CRAM 3.0's "
            "container layout — with block CRC32s — is implemented)")
    return 26                     # magic + version + 20-byte file id


def _read_file_header(buf, off: int) -> Tuple[BamHeader, int, str]:
    ch, off = read_container_header(buf, off)
    end = off + ch.length
    hdr = _header_from_container(buf[off:end])
    return hdr, end, hdr.text


def _header_from_container(data) -> BamHeader:
    off, end, text = 0, len(data), ""
    while off < end:
        blk, off = read_block(data, off)
        if blk.content_type == CT_FILE_HEADER and not text:
            ln = struct.unpack_from("<i", blk.data, 0)[0]
            text = blk.data[4:4 + ln].decode("utf-8", "replace")
    names, lengths = _parse_sam_header(text)
    return BamHeader(text=text, ref_names=names, ref_lengths=lengths)


def _fast_default(fast: Optional[bool]) -> bool:
    if fast is None:
        import os as _os
        return _os.environ.get("DEGNORM_JAX_NO_NATIVE", "0") != "1"
    return fast


def _decode_container_blocks(buf, off: int, end: int, fast: bool,
                             chunks: List[ReadColumns]) -> None:
    """Decode one data container's blocks region [off, end) into column
    chunks — the shared core of the whole-file and streaming readers."""
    blk, off = read_block(buf, off)
    if blk.content_type != CT_COMPRESSION_HEADER:
        raise ValueError("container does not begin with a "
                         "compression header block")
    comp = read_compression_header(blk.data)
    while off < end:
        blk, off = read_block(buf, off)
        if blk.content_type != CT_SLICE_HEADER:
            raise ValueError("expected a slice header block")
        sh = read_slice_header(blk.data)
        core: Optional[BitReader] = None
        ext: Dict[int, _Ext] = {}
        for _ in range(sh.n_blocks):
            b, off = read_block(buf, off)
            if b.content_type == CT_CORE:
                core = BitReader(b.data)
            elif b.content_type == CT_EXTERNAL:
                ext[b.content_id] = _Ext(b.data)
        cols = None
        if fast:
            from degnorm_jax.io.cram_fast import decode_slice_fast
            cols = decode_slice_fast(comp, sh, core, ext, "cram.")
        if cols is None:
            cols = _recs_to_columns(
                _decode_slice(comp, sh, core or BitReader(b""),
                              ext, "cram."))
        chunks.append(cols)


def parse_cram_bytes(buf: bytes, *, tid: Optional[int] = None,
                     drop_unmapped: bool = True,
                     fast: Optional[bool] = None
                     ) -> Tuple[BamHeader, ReadColumns]:
    fast = _fast_default(fast)
    off = _check_magic(buf)
    header, off, _ = _read_file_header(buf, off)

    chunks: List[ReadColumns] = []
    n = len(buf)
    while off < n:
        ch, off = read_container_header(buf, off)
        end = off + ch.length
        # n_records == 0 covers both the spec EOF sentinel container and
        # genuinely empty containers; a bare start == EOF_START test would
        # silently drop real data containers that happen to start at that
        # genomic coordinate.
        if ch.n_records == 0:
            off = end
        else:
            _decode_container_blocks(buf, off, end, fast, chunks)
            off = end
    return header, _filter_columns(_concat_columns(chunks),
                                   tid=tid, drop_unmapped=drop_unmapped)


def read_cram_region(path: str, tid: int, *, drop_unmapped: bool = True,
                     fast: Optional[bool] = None) -> ReadColumns:
    """Stream one chromosome's records, memory-bounded by container.

    Coordinate-sorted CRAMs need no index for this: every container
    header names its reference id, so containers for other chromosomes
    are skipped with a seek — only matching (or multi-ref, id -2)
    containers are read and decoded.  This is the CRAM counterpart of the
    BAI-driven region fetch (io/bam.py:read_bam_region, replacing pysam
    fetch at reference reads.py:225)."""
    fast = _fast_default(fast)
    chunks: List[ReadColumns] = []
    with open(path, "rb") as f:
        for ch, data_start in _walk_containers(f):
            if ch.n_records == 0 or (ch.ref_id >= 0 and ch.ref_id != tid):
                continue
            f.seek(data_start)
            data = f.read(ch.length)
            if len(data) < ch.length:
                raise ValueError("truncated CRAM container")
            _decode_container_blocks(data, 0, ch.length, fast, chunks)
    return _filter_columns(_concat_columns(chunks), tid=tid,
                           drop_unmapped=drop_unmapped)


def _walk_containers(f, *, include_first: bool = False):
    """Yield ``(container_header, data_start_offset)`` for each container
    in an open CRAM file, reading only the headers (the caller seeks and
    reads whatever data it wants).  Grows the probe read when a header
    straddles it (rare: huge landmark lists).  The leading SAM-header
    container is skipped unless ``include_first``."""
    f.seek(0)
    _check_magic(f.read(26))
    pos = 26
    f.seek(0, 2)
    fsize = f.tell()
    first = True
    while pos < fsize:
        f.seek(pos)
        buf = f.read(4096)
        while True:
            try:
                ch, hend = read_container_header(buf, 0)
                break
            except (IndexError, struct.error):
                more = f.read(1 << 20)
                if not more:
                    raise ValueError("truncated CRAM container header")
                buf += more
        data_start = pos + hend
        pos = data_start + ch.length
        if first:
            first = False
            if not include_first:
                continue
        yield ch, data_start


def read_cram_head_qnames(path: str, n_records: int = 301) -> List[str]:
    """Query names of the first mapped records, decoding only leading
    containers — the pairedness sniff (reference reads.py:178-203)
    without a whole-file decode (streaming ETL)."""
    out: List[str] = []
    with open(path, "rb") as f:
        for ch, data_start in _walk_containers(f):
            if len(out) >= n_records:
                break
            if ch.n_records == 0:
                continue
            f.seek(data_start)
            data = f.read(ch.length)
            chunks: List[ReadColumns] = []
            _decode_container_blocks(data, 0, ch.length,
                                     _fast_default(None), chunks)
            cols = _filter_columns(_concat_columns(chunks), tid=None,
                                   drop_unmapped=True)
            out.extend(cols.qnames.tolist())
    return out[:n_records]


def _recs_to_columns(recs: List[_Rec]) -> ReadColumns:
    ops: List[int] = []
    lens: List[int] = []
    offsets = [0]
    for r in recs:
        for o, ln in r.cigar:
            ops.append(o)
            lens.append(ln)
        offsets.append(len(ops))
    return ReadColumns(
        qnames=np.array([r.qname for r in recs], dtype=object),
        tid=np.array([r.tid for r in recs], np.int32),
        pos=np.array([r.pos for r in recs], np.int32),
        flag=np.array([r.bf & 0xFFFF for r in recs], np.uint16),
        rnext=np.array([r.rnext for r in recs], np.int32),
        nh=np.array([r.nh for r in recs], np.int32),
        cigar_ops=np.array(ops, np.int8),
        cigar_lens=np.array(lens, np.int32),
        cigar_offsets=np.array(offsets, np.int64),
    )


def _concat_columns(chunks: List[ReadColumns]) -> ReadColumns:
    if len(chunks) == 1:
        return chunks[0]
    if not chunks:
        return _recs_to_columns([])
    offs = [chunks[0].cigar_offsets]
    for c in chunks[1:]:
        offs.append(c.cigar_offsets[1:] + offs[-1][-1])

    def opt(field):
        # optional pairing columns survive only when every chunk has them
        # (a per-record-decoded chunk leaves them None)
        vals = [getattr(c, field) for c in chunks]
        return (np.concatenate(vals)
                if all(v is not None for v in vals) else None)

    return ReadColumns(
        qnames=np.concatenate([c.qnames for c in chunks]),
        tid=np.concatenate([c.tid for c in chunks]),
        pos=np.concatenate([c.pos for c in chunks]),
        flag=np.concatenate([c.flag for c in chunks]),
        rnext=np.concatenate([c.rnext for c in chunks]),
        nh=np.concatenate([c.nh for c in chunks]),
        cigar_ops=np.concatenate([c.cigar_ops for c in chunks]),
        cigar_lens=np.concatenate([c.cigar_lens for c in chunks]),
        cigar_offsets=np.concatenate(offs),
        pair_hash=opt("pair_hash"),
        mate_code=opt("mate_code"),
    )


def _filter_columns(cols: ReadColumns, *, tid: Optional[int],
                    drop_unmapped: bool) -> ReadColumns:
    mask = np.ones(len(cols), dtype=bool)
    if tid is not None:
        mask &= cols.tid == tid
    if drop_unmapped:
        mask &= (cols.flag & FLAG_UNMAPPED) == 0
    if mask.all():
        return cols
    return subset_columns(cols, mask)


# ---------------------------------------------------------------------------
# writer (test fixtures / interop)
# ---------------------------------------------------------------------------

_DS_INT = ["BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
           "NF", "TL", "FN", "FP", "DL", "HC", "PD", "RS", "MQ"]
_DS_BYTE = ["FC", "BA", "QS", "BS"]
_DS_ARR = ["IN", "SC", "BB", "QQ"]


class _SeriesWriter:
    """Accumulates every data series into its own external byte stream."""

    def __init__(self):
        self.streams: Dict[str, bytearray] = {}
        self.cids: Dict[str, int] = {}
        next_cid = [1]

        def cid(key):
            if key not in self.cids:
                self.cids[key] = next_cid[0]
                next_cid[0] += 1
                self.streams[key] = bytearray()
            return self.cids[key]
        self._cid = cid
        for k in _DS_INT + _DS_BYTE + _DS_ARR + ["RN", "TAGL", "TAGV"]:
            cid(k)

    def put_int(self, key: str, v: int) -> None:
        write_itf8(self.streams[key], v)

    def put_byte(self, key: str, v: int) -> None:
        self.streams[key].append(v)

    def put_name(self, name: str) -> None:
        self.streams["RN"] += name.encode("latin-1") + b"\x00"

    def put_arr(self, key: str, data: bytes) -> None:
        self.streams[key] += data + b"\x00"

    def put_tag(self, raw: bytes) -> None:
        write_itf8(self.streams["TAGL"], len(raw))
        self.streams["TAGV"] += raw


def _cigar_from_str(cigar: str) -> List[Tuple[str, int]]:
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((ch, int(num)))
            num = ""
    return out


def _query_len(cig: List[Tuple[str, int]]) -> int:
    return sum(ln for op, ln in cig if op in _Q_CONSUMES)


def write_cram(path: str, ref_names: Sequence[str],
               ref_lengths: Sequence[int], records: Iterable[Tuple],
               *, compression: str = "gzip", preserve_names: bool = True,
               ap_delta: bool = True, records_per_slice: int = 4096,
               link_mates: bool = False) -> None:
    """Write a CRAM 3.0 file.

    ``records``: the io/bam.py writer's tuple shape —
    (qname, tid, pos0, flag, cigar_str, rnext[, nh]).  Base sequences are
    synthesized ('A') where the format requires them (insertions, soft
    clips, unmapped reads); '='/'X' CIGAR runs canonicalize to 'M'.
    ``compression``: raw | gzip | rans (block codec for external blocks).
    ``link_mates``: emit consecutive same-qname runs as within-slice
    mate links (NF series) instead of detached records; runs of 3+
    records become NF chains.
    """
    method = {"raw": M_RAW, "gzip": M_GZIP, "rans": M_RANS}[compression]
    recs = [tuple(r) for r in records]

    out = bytearray()
    out += CRAM_MAGIC + bytes([3, 0]) + b"degnorm-jax".ljust(20, b"\x00")

    # --- SAM header container
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ref_names, ref_lengths))
    tb = text.encode()
    hdr_block = Block(M_RAW, CT_FILE_HEADER, 0,
                      struct.pack("<i", len(tb)) + tb)
    blocks = bytearray()
    write_block(blocks, hdr_block)
    write_container_header(out, ContainerHeader(
        len(blocks), 0, 0, 0, 0, 0, 0, 1, [0]))
    out += blocks

    # --- data containers (one slice per container)
    counter = 0
    for s0 in range(0, len(recs), records_per_slice):
        chunk = recs[s0:s0 + records_per_slice]
        body, n_blocks, meta = _build_slice_container(
            chunk, counter, method, preserve_names, ap_delta, link_mates)
        write_container_header(out, ContainerHeader(
            len(body), meta["ref_id"], meta["start"], meta["span"],
            len(chunk), counter, meta["bases"], n_blocks,
            meta["landmarks"]))
        out += body
        counter += len(chunk)

    # --- EOF container: an empty compression-header block at the
    # sentinel position (start == EOF_START, zero records)
    eof_blocks = bytearray()
    write_block(eof_blocks, Block(
        M_RAW, CT_COMPRESSION_HEADER, 0,
        bytes(_map_bytes([]) + _map_bytes([]) + _map_bytes([]))))
    write_container_header(out, ContainerHeader(
        len(eof_blocks), -1, EOF_START, 0, 0, 0, 0, 1, [0]))
    out += eof_blocks

    with open(path, "wb") as f:
        f.write(bytes(out))


def _build_slice_container(chunk, counter: int, method: int,
                           preserve_names: bool, ap_delta: bool,
                           link_mates: bool):
    sw = _SeriesWriter()
    tids = sorted({int(r[1]) for r in chunk})
    multi_ref = len(tids) != 1
    slice_ref = -2 if multi_ref else tids[0]
    positions = [int(r[2]) + 1 for r in chunk]
    start = min(positions) if positions else 0
    span = (max(p + 1 for p in positions) - start) if positions else 0
    # the decoder's AP-delta chain seeds from the slice header's start
    # field, which multi-ref slices record as 0 — seed the writer the same
    hdr_start = 0 if multi_ref else start

    # tag dictionary: line 0 = no tags, line 1 = NH:i
    td_lines = [[], [("NH", "i")]]

    # within-slice mate linking: every same-qname consecutive adjacency
    # becomes one NF link, so runs of 3+ records form spec-legal NF
    # *chains* (multi-segment templates) — a record may be both a link
    # target and the next link's leader
    mate_of = {}
    if link_mates:
        for i in range(len(chunk) - 1):
            if chunk[i][0] == chunk[i + 1][0]:
                mate_of[i] = i + 1

    prev_ap = hdr_start
    bases = 0
    linked_tail = set(mate_of.values())
    for i, rec in enumerate(chunk):
        qname, tid_, pos0, flag, cigar, rnext = rec[:6]
        nh = rec[6] if len(rec) > 6 else None
        ap = int(pos0) + 1
        cig = _cigar_from_str(cigar) if cigar else []
        rl = _query_len(cig)
        bases += rl

        if i in mate_of:
            cf = CF_MATE_DOWNSTREAM
        elif i in linked_tail:
            cf = 0
        else:
            cf = CF_DETACHED
        sw.put_int("BF", int(flag))
        sw.put_int("CF", cf)
        if multi_ref:
            sw.put_int("RI", int(tid_))
        sw.put_int("RL", rl)
        if ap_delta:
            sw.put_int("AP", ap - prev_ap)
            prev_ap = ap
        else:
            sw.put_int("AP", ap)
        sw.put_int("RG", -1)
        if preserve_names:
            sw.put_name(qname)
        if cf & CF_DETACHED:
            mf = ((1 if flag & FLAG_MATE_REVERSE else 0)
                  | (2 if flag & FLAG_MATE_UNMAPPED else 0))
            sw.put_int("MF", mf)
            if not preserve_names:
                sw.put_name(qname)
            sw.put_int("NS", int(rnext))
            sw.put_int("NP", 0)
            sw.put_int("TS", 0)
        elif cf & CF_MATE_DOWNSTREAM:
            sw.put_int("NF", mate_of[i] - i - 1)
        if nh is not None:
            sw.put_int("TL", 1)
            sw.put_tag(struct.pack("<i", int(nh)))
        else:
            sw.put_int("TL", 0)

        if not (int(flag) & FLAG_UNMAPPED):
            _write_features(sw, cig, rl)
            sw.put_int("MQ", 60)
        else:
            for _ in range(rl):
                sw.put_byte("BA", ord("A"))

    # --- compression header
    pres = [b"RN" + bytes([1 if preserve_names else 0]),
            b"AP" + bytes([1 if ap_delta else 0]),
            b"RR" + bytes([0]),
            b"SM" + bytes([0x1B, 0x1B, 0x1B, 0x1B, 0x1B])]
    td_raw = bytearray()
    for line in td_lines:
        for tag, typ in line:
            td_raw += tag.encode() + typ.encode()
        td_raw.append(0)
    td_entry = bytearray(b"TD")
    write_itf8(td_entry, len(td_raw))
    td_entry += td_raw
    pres.append(bytes(td_entry))

    ds_entries = []
    for key in _DS_INT + _DS_BYTE:
        e = bytearray(key.encode())
        _write_encoding(e, *enc_external(sw.cids[key]))
        ds_entries.append(bytes(e))
    for key in _DS_ARR:
        e = bytearray(key.encode())
        _write_encoding(e, *enc_byte_array_stop(0, sw.cids[key]))
        ds_entries.append(bytes(e))
    e = bytearray(b"RN")
    _write_encoding(e, *enc_byte_array_stop(0, sw.cids["RN"]))
    ds_entries.append(bytes(e))

    tag_entries = []
    key = (ord("N") << 16) | (ord("H") << 8) | ord("i")
    e = bytearray()
    write_itf8(e, key)
    _write_encoding(e, *enc_byte_array_len(
        enc_external(sw.cids["TAGL"]), enc_external(sw.cids["TAGV"])))
    tag_entries.append(bytes(e))

    comp_data = (_map_bytes(pres) + _map_bytes(ds_entries)
                 + _map_bytes(tag_entries))

    # --- blocks: compression header, slice header, core, externals
    used = [(k, cid) for k, cid in sorted(sw.cids.items(),
                                          key=lambda kv: kv[1])
            if len(sw.streams[k])]
    slice_hdr = bytearray()
    write_itf8(slice_hdr, slice_ref)
    write_itf8(slice_hdr, hdr_start)
    write_itf8(slice_hdr, span if not multi_ref else 0)
    write_itf8(slice_hdr, len(chunk))
    write_ltf8(slice_hdr, counter)
    write_itf8(slice_hdr, 1 + len(used))          # core + externals
    write_itf8(slice_hdr, len(used))
    for _, cid in used:
        write_itf8(slice_hdr, cid)
    write_itf8(slice_hdr, -1)                     # no embedded reference
    slice_hdr += b"\x00" * 16                     # md5 (unset)

    body = bytearray()
    write_block(body, Block(M_RAW, CT_COMPRESSION_HEADER, 0,
                            comp_data), method)
    landmarks = [len(body)]
    write_block(body, Block(M_RAW, CT_SLICE_HEADER, 0, bytes(slice_hdr)))
    write_block(body, Block(M_RAW, CT_CORE, 0, b""))
    for k, cid in used:
        write_block(body, Block(M_RAW, CT_EXTERNAL, cid,
                                bytes(sw.streams[k])), method)
    meta = {"ref_id": slice_ref, "start": hdr_start,
            "span": span if not multi_ref else 0, "bases": bases,
            "landmarks": landmarks}
    return bytes(body), 3 + len(used), meta


def _write_features(sw: _SeriesWriter, cig: List[Tuple[str, int]],
                    rl: int) -> None:
    """Emit FC/FP/... features for one mapped read.  M/=/X runs are
    implicit (gap-fill); I/S need synthesized bases."""
    feats = []                     # (code, read_pos_1based, payload)
    read_pos = 1
    for op, ln in cig:
        if op in "M=X":
            read_pos += ln
        elif op == "I":
            feats.append(("I", read_pos, b"A" * ln))
            read_pos += ln
        elif op == "S":
            feats.append(("S", read_pos, b"A" * ln))
            read_pos += ln
        elif op == "D":
            feats.append(("D", read_pos, ln))
        elif op == "N":
            feats.append(("N", read_pos, ln))
        elif op == "P":
            feats.append(("P", read_pos, ln))
        elif op == "H":
            feats.append(("H", read_pos, ln))
        else:
            raise ValueError(f"cannot express CIGAR op {op!r} in CRAM")
    sw.put_int("FN", len(feats))
    prev = 0
    for code, pos, payload in feats:
        sw.put_byte("FC", ord(code))
        sw.put_int("FP", pos - prev)
        prev = pos
        if code == "I":
            sw.put_arr("IN", payload)
        elif code == "S":
            sw.put_arr("SC", payload)
        elif code == "D":
            sw.put_int("DL", payload)
        elif code == "N":
            sw.put_int("RS", payload)
        elif code == "P":
            sw.put_int("PD", payload)
        elif code == "H":
            sw.put_int("HC", payload)
