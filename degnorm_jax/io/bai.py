"""BAI (BAM index) writing and reading.

The reference shells out to ``samtools index`` to create missing .bai files
(``utils.py:149-173``) and relies on pysam's BAI-driven ``fetch``
(``reads.py:225``).  Here the index format itself is implemented (SAM spec
§5.2): the R-tree binning scheme (reg2bin), 16 kb linear index windows, and
BGZF virtual file offsets — so indexes can be built without samtools and
used for region-restricted reads without inflating whole files.

A BAI is not *required* by this pipeline (the readers stream), but indexes
make per-chromosome fetches on large files cheap and keep the output
ecosystem interoperable (files we write can be indexed for IGV/samtools).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from degnorm_jax.io import bgzf

BAI_MAGIC = b"BAI\x01"
_LINEAR_SHIFT = 14               # 16 kb windows
_MAX_BIN = 37450                 # bin count for a 512 Mb reference


def reg2bin(beg: int, end: int) -> int:
    """Smallest R-tree bin containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (SAM spec §5.3)."""
    end -= 1
    out = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


class BaiIndex:
    """Parsed BAI: per-reference {bin: [(voff_start, voff_end), ...]} plus
    the 16 kb linear index."""

    def __init__(self, bins: List[Dict[int, List[Tuple[int, int]]]],
                 linear: List[List[int]]):
        self.bins = bins
        self.linear = linear

    def chunks_for(self, tid: int, beg: int = 0,
                   end: int = 1 << 29) -> List[Tuple[int, int]]:
        """Candidate (voff_start, voff_end) chunks for a region, pruned by
        the linear index and merged."""
        if tid >= len(self.bins):
            return []
        min_off = 0
        lin = self.linear[tid]
        w = beg >> _LINEAR_SHIFT
        if w < len(lin):
            min_off = lin[w]
        chunks = []
        for b in reg2bins(beg, end):
            for s, e in self.bins[tid].get(b, ()):
                if e > min_off:
                    chunks.append((max(s, min_off), e))
        chunks.sort()
        merged: List[List[int]] = []
        for s, e in chunks:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]


class RefIndexAccumulator:
    """Incremental per-reference BAI aggregation: feed alignments in file
    order, serialize at the end — O(bins + linear windows) memory, never a
    per-record list (lets index_bam stream arbitrarily large BAMs)."""

    def __init__(self):
        self.bins: Dict[int, List[Tuple[int, int]]] = {}
        self.linear: List[int] = []
        self.filled: List[bool] = []

    def add(self, pos: int, end: int, vs: int, ve: int) -> None:
        end = max(end, pos + 1)
        b = reg2bin(pos, end)
        lst = self.bins.setdefault(b, [])
        # merge chunks adjacent in the file
        if lst and lst[-1][1] == vs:
            lst[-1] = (lst[-1][0], ve)
        else:
            lst.append((vs, ve))
        w_hi = (end - 1) >> _LINEAR_SHIFT
        if w_hi >= len(self.linear):
            grow = w_hi + 1 - len(self.linear)
            self.linear.extend([0] * grow)
            self.filled.extend([False] * grow)
        for w in range(pos >> _LINEAR_SHIFT, w_hi + 1):
            if not self.filled[w] or vs < self.linear[w]:
                self.linear[w] = vs
                self.filled[w] = True

    def serialize(self) -> bytes:
        # backfill empty leading windows per spec convention
        prev = 0
        for w in range(len(self.linear)):
            if not self.filled[w]:
                self.linear[w] = prev
            prev = self.linear[w]
        out = [struct.pack("<i", len(self.bins))]
        for b in sorted(self.bins):
            out.append(struct.pack("<Ii", b, len(self.bins[b])))
            for s, e in self.bins[b]:
                out.append(struct.pack("<QQ", s, e))
        out.append(struct.pack("<i", len(self.linear)))
        for v in self.linear:
            out.append(struct.pack("<Q", v))
        return b"".join(out)


def write_bai(path: str,
              per_ref_records: List[List[Tuple[int, int, int, int]]]) -> None:
    """Write a .bai. per_ref_records[tid] lists (pos0, end0_excl,
    voff_start, voff_end) per alignment, in file order."""
    out = [BAI_MAGIC, struct.pack("<i", len(per_ref_records))]
    for recs in per_ref_records:
        acc = RefIndexAccumulator()
        for pos, end, vs, ve in recs:
            acc.add(pos, end, vs, ve)
        out.append(acc.serialize())
    with open(path, "wb") as f:
        f.write(b"".join(out))


def index_bam(bam_path: str, bai_path: str = None) -> str:
    """Build a .bai for an existing BAM — the native replacement for the
    reference's ``samtools index`` shell-out (utils.py:149-173).

    Streams the file once with bounded memory (it is invoked precisely on
    large files in auto-stream mode): BGZF blocks inflate incrementally,
    parsed bytes are evicted, and per-reference bins/linear windows
    aggregate via RefIndexAccumulator instead of per-record lists.
    SAM-spec reference lengths (M/D/N/=/X) drive the binning."""
    import numpy as np
    from degnorm_jax.io import bam as bamio

    accs: List[RefIndexAccumulator] = []
    hdr_parsed = False
    data = bytearray()       # decompressed tail not yet parsed
    base_u = 0               # absolute uncompressed offset of data[0]
    parse_from = 0           # absolute uncompressed parse cursor
    # block table rows (u_start, c_start); blocks arrive in order
    tbl_u: List[int] = []
    tbl_c: List[int] = []
    c_off = 0
    raw = bytearray()
    raw_base = 0

    import bisect

    def voff(u: int) -> int:
        i = bisect.bisect_right(tbl_u, u) - 1
        if i < 0:
            return 0
        return (tbl_c[i] << 16) | (u - tbl_u[i])

    with open(bam_path, "rb") as f:
        eof = False
        while True:
            chunk = f.read(4 << 20)
            if chunk:
                raw.extend(chunk)
            else:
                eof = True
            progressed = False
            with memoryview(raw) as view:
                while True:
                    off = c_off - raw_base
                    bsize = bgzf.block_size_at(view, off)
                    if bsize is None or off + bsize > len(raw):
                        break
                    blk, _ = bgzf._read_block(view, off)
                    tbl_u.append(base_u + len(data))
                    tbl_c.append(c_off)
                    data.extend(blk)
                    c_off += bsize
                    progressed = True
            # evict consumed compressed bytes
            drop = (c_off - raw_base) if progressed else 0
            if drop > 0:
                del raw[:drop]
                raw_base = c_off

            if not hdr_parsed and len(data) >= 12:
                try:
                    hdr, hdr_end = bamio._parse_header(bytes(data))
                    accs = [RefIndexAccumulator() for _ in hdr.ref_names]
                    parse_from = hdr_end
                    del data[:hdr_end]
                    base_u = hdr_end
                    hdr_parsed = True
                except (struct.error, IndexError):
                    pass

            if hdr_parsed:
                buf = bytes(data)
                p = parse_from - base_u
                while p + 4 <= len(buf):
                    bs = struct.unpack_from("<i", buf, p)[0]
                    if p + 4 + bs > len(buf):
                        break
                    r = p + 4
                    refID, pos = struct.unpack_from("<ii", buf, r)
                    lrn = buf[r + 8]
                    n_cigar = struct.unpack_from("<H", buf, r + 12)[0]
                    flag = struct.unpack_from("<H", buf, r + 14)[0]
                    if 0 <= refID < len(accs) and not (flag & 0x4):
                        cig = np.frombuffer(buf, "<u4", n_cigar, r + 32 + lrn)
                        ops = cig & 0xF
                        ref_len = int((cig >> 4)[
                            (ops == 0) | (ops == 2) | (ops == 3)
                            | (ops == 7) | (ops == 8)].sum())
                        accs[refID].add(pos, pos + max(ref_len, 1),
                                        voff(base_u + p),
                                        voff(base_u + p + 4 + bs))
                    p += 4 + bs
                # evict parsed decompressed bytes and stale voff-table rows
                # (voff only ever queries offsets >= parse_from; keep the
                # covering block) — keeps the whole pass O(1) memory
                parse_from = base_u + p
                del data[:p]
                base_u = parse_from
                cut = bisect.bisect_right(tbl_u, parse_from) - 1
                if cut > 0:
                    del tbl_u[:cut]
                    del tbl_c[:cut]

            if eof and not progressed:
                break

    if not hdr_parsed:
        raise ValueError(f"not a BAM file: {bam_path}")
    if bai_path is None:
        bai_path = bam_path + ".bai"
    out = [BAI_MAGIC, struct.pack("<i", len(accs))]
    out.extend(a.serialize() for a in accs)
    with open(bai_path, "wb") as f:
        f.write(b"".join(out))
    return bai_path


def read_bai(path: str) -> BaiIndex:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != BAI_MAGIC:
        raise ValueError("not a BAI file")
    off = 4
    (n_ref,) = struct.unpack_from("<i", buf, off)
    off += 4
    bins_all, linear_all = [], []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", buf, off)
        off += 4
        bins: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", buf, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                s, e = struct.unpack_from("<QQ", buf, off)
                off += 16
                chunks.append((s, e))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", buf, off)
        off += 4
        linear = list(struct.unpack_from(f"<{n_intv}Q", buf, off))
        off += 8 * n_intv
        bins_all.append(bins)
        linear_all.append(linear)
    return BaiIndex(bins_all, linear_all)


def fetch_region_bytes(bam_path: str, index: BaiIndex, tid: int,
                       beg: int = 0, end: int = 1 << 29) -> bytes:
    """Inflate only the BGZF blocks covering a region's chunks; returns the
    concatenated uncompressed byte range per chunk (callers slice records
    out of it).  Virtual offset = (compressed_block_start << 16) | intra.

    Memory-bounded: seeks to each chunk and reads only its compressed span
    (+ one max-size BGZF block of slack for the final block), so fetching
    one chromosome of a large BAM never loads the whole file — this is
    what lets the ETL stream per-chromosome (pipeline/sample.py)."""
    out = []
    with open(bam_path, "rb") as f:
        for vs, ve in index.chunks_for(tid, beg, end):
            coff, intra = vs >> 16, vs & 0xFFFF
            coff_end, intra_end = ve >> 16, ve & 0xFFFF
            f.seek(coff)
            raw = f.read((coff_end - coff) + (1 << 16) + 64)
            view = memoryview(raw)
            rel_end = coff_end - coff
            pos = 0
            datas = []
            while pos <= rel_end and pos < len(raw):
                data, nxt = bgzf._read_block(view, pos)
                if pos == rel_end:
                    data = data[:intra_end]
                if pos == 0:
                    data = data[intra:]
                datas.append(data)
                if pos == rel_end:
                    break
                pos = nxt
            out.append(b"".join(datas))
    return b"".join(out)
