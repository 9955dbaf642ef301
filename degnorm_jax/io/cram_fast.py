"""Vectorized CRAM slice decode for the common encoding profile.

io/cram.py's per-record decoder (the semantic reference, kept as the
fallback and test oracle) runs at ~80k records/s — 15x slower than the
native BAM path.  This module decodes a whole slice with numpy prefix
sums instead, for slices whose compression header uses the profile that
htslib and io/cram.py's writer emit:

- every consumed int series is EXTERNAL (own block) or a 0-bit HUFFMAN
  constant;
- RN / IN / SC / BB are BYTE_ARRAY_STOP;
- the NH tag (the only tag DegNorm reads) is BYTE_ARRAY_LEN(EXTERNAL,
  EXTERNAL);
- no two consumed series share an external block.

Because each series owns its block, series the pipeline never uses
(bases, quals, mapping quality, mate NP/TS, BS substitution codes) are
simply never read — there is no interleaving to honor.  ITF8 streams are
scanned by the native dn_itf8_scan kernel (io/native/rans_kernel.cpp);
without the native library the fast path reports unsupported and the
caller falls back.

Returns None whenever any assumption fails; io/cram.py then uses the
per-record path.  Equality of the two paths is fuzz-checked in
tests/test_cram.py.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from degnorm_jax.io import cram as C


def _scan_itf8(block: bytes) -> Optional[np.ndarray]:
    from degnorm_jax.io.native.build import get_fn
    fn = get_fn("dn_itf8_scan")
    if fn is None:
        return None
    out = np.empty(len(block) or 1, dtype=np.int32)
    n = fn(block, len(block),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(out))
    if n < 0:
        return None
    return out[:n]


class _Unsupported(Exception):
    """Profile assumption failed — fall back to the per-record decoder."""


class _Series:
    """Resolves data series against the profile's constraints."""

    def __init__(self, ch: C.CompressionHeader, ext: Dict[int, "C._Ext"]):
        self.ch = ch
        self.ext = ext
        self.used_cids: set = set()
        self._scans: Dict[int, np.ndarray] = {}

    def _enc(self, key: str):
        enc = self.ch.ds.get(key)
        if enc is None:
            raise _Unsupported(key)
        return enc

    def _claim(self, cid: int) -> None:
        if cid in self.used_cids:
            raise _Unsupported(f"shared external block {cid}")
        self.used_cids.add(cid)

    def _block(self, cid: int) -> bytes:
        e = self.ext.get(cid)
        return e.data if e is not None else b""

    def ints(self, key: str, count: int) -> np.ndarray:
        """All `count` values of an int series, in record order."""
        enc = self._enc(key)
        if enc.codec == C.E_HUFFMAN and getattr(enc, "const", None) \
                is not None:
            return np.full(count, enc.const, dtype=np.int64)
        if enc.codec != C.E_EXTERNAL:
            raise _Unsupported(f"{key} codec {enc.codec}")
        if count == 0:
            return np.zeros(0, dtype=np.int64)
        self._claim(enc.cid)
        if enc.cid not in self._scans:
            arr = _scan_itf8(self._block(enc.cid))
            if arr is None:
                raise _Unsupported(f"{key} itf8 scan")
            self._scans[enc.cid] = arr
        arr = self._scans[enc.cid]
        if len(arr) != count:
            raise _Unsupported(f"{key} count {len(arr)} != {count}")
        return arr.astype(np.int64)

    def byte_stream(self, key: str, count: int) -> np.ndarray:
        enc = self._enc(key)
        if enc.codec != C.E_EXTERNAL:
            raise _Unsupported(f"{key} codec {enc.codec}")
        if count == 0:
            return np.zeros(0, dtype=np.uint8)
        self._claim(enc.cid)
        blk = self._block(enc.cid)
        if len(blk) != count:
            raise _Unsupported(f"{key} byte count")
        return np.frombuffer(blk, dtype=np.uint8)

    def stop_items(self, key: str, count: int
                   ) -> Tuple[bytes, np.ndarray, np.ndarray]:
        """(block, starts, lens) of a BYTE_ARRAY_STOP series' items."""
        enc = self._enc(key)
        if enc.codec != C.E_BYTE_ARRAY_STOP:
            raise _Unsupported(f"{key} codec {enc.codec}")
        if count == 0:
            return b"", np.zeros(0, np.int64), np.zeros(0, np.int64)
        self._claim(enc.cid)
        blk = self._block(enc.cid)
        stops = np.flatnonzero(np.frombuffer(blk, np.uint8) == enc.stop)
        if len(stops) != count or (len(blk) and stops[-1] != len(blk) - 1):
            raise _Unsupported(f"{key} item count")
        starts = np.concatenate([[0], stops[:-1] + 1])
        return blk, starts.astype(np.int64), (stops - starts).astype(
            np.int64)


def _cumsum0(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, dtype=np.int64)
    np.cumsum(a, out=out[1:])
    return out


def _pair_hash_native(blk: bytes, starts: np.ndarray, lens: np.ndarray
                      ) -> Tuple[Optional[np.ndarray],
                                 Optional[np.ndarray]]:
    """(pair_hash, mate_code) for names packed in one byte buffer, via the
    native batch kernel; (None, None) when unavailable (callers then leave
    the optional columns unset and pairing falls back to string codes)."""
    from degnorm_jax.io.native.build import get_fn
    fn = get_fn("dn_pair_hash")
    if fn is None:
        return None, None
    n = len(starts)
    out_h = np.empty(n, np.uint64)
    out_m = np.empty(n, np.int8)
    if n == 0:
        # empty arrays, not None: _concat_columns keeps the pairing
        # columns only when EVERY chunk has them, so a zero-record slice
        # must not nullify the whole file's
        return out_h, out_m
    st = np.ascontiguousarray(starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    fn(blk,
       st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       n,
       out_h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
       out_m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out_h, out_m


_Q_ONE = {ord("i"), ord("B"), ord("X")}          # consume one query base
_NO_OP = {ord("q"), ord("Q")}                    # no cigar effect
_OP_OF = {ord("S"): 4, ord("I"): 1, ord("i"): 1, ord("b"): 0,
          ord("B"): 0, ord("X"): 0, ord("D"): 2, ord("N"): 3,
          ord("P"): 6, ord("H"): 5}
_LEN_SERIES = {ord("D"): "DL", ord("N"): "RS", ord("P"): "PD",
               ord("H"): "HC"}
_ARR_SERIES = {ord("I"): "IN", ord("S"): "SC", ord("b"): "BB"}


def decode_slice_fast(ch: C.CompressionHeader, sh: C.SliceHeader,
                      core: "C.BitReader", ext: Dict[int, "C._Ext"],
                      name_prefix: str) -> Optional["C.ReadColumns"]:
    """Whole-slice vectorized decode; None if the profile is unsupported
    (caller falls back to the per-record reference decoder)."""
    try:
        return _decode(ch, sh, ext, name_prefix)
    except _Unsupported:
        return None


def _decode(ch, sh, ext, name_prefix) -> "C.ReadColumns":
    from degnorm_jax.io.bam import ReadColumns

    S = _Series(ch, ext)
    n = sh.n_records

    bf = S.ints("BF", n)
    cf = S.ints("CF", n)
    tid = (S.ints("RI", n) if sh.ref_id == -2
           else np.full(n, sh.ref_id, dtype=np.int64))
    rl = S.ints("RL", n)
    ap = S.ints("AP", n)
    if ch.ap_delta:
        ap = sh.start + np.cumsum(ap)
    pos0 = ap - 1

    detached = (cf & C.CF_DETACHED) != 0
    downstream = ~detached & ((cf & C.CF_MATE_DOWNSTREAM) != 0)
    mapped = (bf & C.FLAG_UNMAPPED) == 0

    # --- read names
    names: List[Optional[str]]
    pair_hash = mate_code = None
    if ch.rn_preserved:
        blk, starts, lens = S.stop_items("RN", n)
        text = blk.decode("latin-1")
        names = [text[starts[i]:starts[i] + lens[i]] for i in range(n)]
        # pairing columns straight off the name bytes (no Python string
        # work) so the native coverage kernel's paired path engages for
        # CRAM input like it does for natively-read BAM
        pair_hash, mate_code = _pair_hash_native(blk, starts, lens)
    else:
        nd = int(detached.sum())
        names = [None] * n
        if nd:
            blk, starts, lens = S.stop_items("RN", nd)
            text = blk.decode("latin-1")
            for k, i in enumerate(np.flatnonzero(detached)):
                names[i] = text[starts[k]:starts[k] + lens[k]]

    # --- mate info
    nd = int(detached.sum())
    mf = S.ints("MF", nd)
    ns = S.ints("NS", nd)
    nf = S.ints("NF", int(downstream.sum()))

    rnext = np.full(n, -1, dtype=np.int64)
    rnext[detached] = ns
    bf[detached] |= np.where(mf & 0x1, C.FLAG_MATE_REVERSE, 0)
    bf[detached] |= np.where(mf & 0x2, C.FLAG_MATE_UNMAPPED, 0)

    i_idx = np.flatnonzero(downstream)
    j_idx = i_idx + nf + 1
    if len(j_idx) and int(j_idx.max()) >= n:
        raise ValueError("CRAM mate link escapes its slice")
    # Match the per-record decoder's sequential link resolution
    # (cram.py:703-724) exactly, including NF *chains* — a record that is
    # both a link target and itself a leader keeps its own forward link:
    # per link (i, j=i+nf+1) in ascending i, rnext[i]=tid[j] then
    # rnext[j]=tid[i]; since j > i always, a leader's forward write is the
    # last write to its row, and for duplicate targets the later leader's
    # backlink wins.
    if len(j_idx):
        uj, rev = np.unique(j_idx[::-1], return_index=True)
        rnext[uj] = tid[i_idx[::-1][rev]]   # last leader per target
    rnext[i_idx] = tid[j_idx]               # forward writes override
    # Flag propagation only reads REVERSE/UNMAPPED (never the MATE_* bits
    # it writes), so it is order-independent; use or.at for the duplicate
    # targets the plain |= fancy-assignment would apply only once.
    bf_i, bf_j = bf[i_idx], bf[j_idx]
    bf[i_idx] |= (np.where(bf_j & C.FLAG_REVERSE, C.FLAG_MATE_REVERSE, 0)
                  | np.where(bf_j & C.FLAG_UNMAPPED,
                             C.FLAG_MATE_UNMAPPED, 0))
    np.bitwise_or.at(
        bf, j_idx,
        np.where(bf_i & C.FLAG_REVERSE, C.FLAG_MATE_REVERSE, 0)
        | np.where(bf_i & C.FLAG_UNMAPPED, C.FLAG_MATE_UNMAPPED, 0))

    if not ch.rn_preserved:
        # sequential semantics: a leader names itself (if unnamed), the
        # target inherits the leader's name only if still unnamed — so a
        # chain shares the head leader's name and a doubly-targeted
        # record keeps the FIRST leader's name.
        for i, j in zip(i_idx, j_idx):
            if names[i] is None:
                names[i] = f"{name_prefix}{sh.counter + i}"
            if names[j] is None:
                names[j] = names[i]
        for i in range(n):               # generated names (cheap: no IO)
            if names[i] is None:
                names[i] = f"{name_prefix}{sh.counter + i}"

    # --- NH tag
    tl = S.ints("TL", n)
    if len(tl) and (int(tl.max()) >= len(ch.td) or int(tl.min()) < 0):
        raise _Unsupported("TL out of range")
    nh = _decode_nh(S, ch, tl, n)

    # --- features -> cigars
    cig_ops, cig_lens, cig_offsets = _decode_cigars(S, sh, mapped, rl)

    return ReadColumns(
        qnames=np.array(names, dtype=object),
        tid=tid.astype(np.int32),
        pos=pos0.astype(np.int32),
        flag=(bf & 0xFFFF).astype(np.uint16),
        rnext=rnext.astype(np.int32),
        nh=nh.astype(np.int32),
        cigar_ops=cig_ops,
        cigar_lens=cig_lens,
        cigar_offsets=cig_offsets,
        pair_hash=pair_hash,
        mate_code=mate_code,
    )


def _decode_nh(S: _Series, ch, tl: np.ndarray, n: int) -> np.ndarray:
    nh = np.zeros(n, dtype=np.int64)
    nh_keys = set()
    line_has = np.zeros(len(ch.td), dtype=bool)
    for li, line in enumerate(ch.td):
        for tag, typ in line:
            if tag == "NH":
                line_has[li] = True
                nh_keys.add((ord("N") << 16) | (ord("H") << 8) | ord(typ))
    if not nh_keys:
        return nh
    if len(nh_keys) > 1:
        raise _Unsupported("multiple NH tag types")
    key = next(iter(nh_keys))
    typ = chr(key & 0xFF)
    width = C._TAG_SIZES.get(typ)
    fmt = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
           "i": "<i4", "I": "<u4"}.get(typ)
    if width is None or fmt is None:
        raise _Unsupported(f"NH type {typ}")
    enc = ch.tags.get(key)
    if enc is None or enc.codec != C.E_BYTE_ARRAY_LEN:
        raise _Unsupported("NH encoding")
    len_enc, val_enc = enc.len_enc, enc.val_enc
    if len_enc.codec != C.E_EXTERNAL or val_enc.codec != C.E_EXTERNAL:
        raise _Unsupported("NH sub-encodings")
    has = line_has[tl]
    cnt = int(has.sum())
    if cnt == 0:
        return nh
    S._claim(len_enc.cid)
    lens = _scan_itf8(S._block(len_enc.cid))
    if lens is None or len(lens) != cnt or not (lens == width).all():
        raise _Unsupported("NH length stream")
    S._claim(val_enc.cid)
    blk = S._block(val_enc.cid)
    if len(blk) != cnt * width:
        raise _Unsupported("NH value stream")
    nh[has] = np.frombuffer(blk, dtype=fmt).astype(np.int64)
    return nh


def _decode_cigars(S: _Series, sh, mapped: np.ndarray, rl: np.ndarray):
    n = len(mapped)
    m_idx = np.flatnonzero(mapped)
    fn = S.ints("FN", len(m_idx))
    F = int(fn.sum())
    fc = S.byte_stream("FC", F)
    fp = S.ints("FP", F)

    # absolute feature positions: segmented (per-record) cumsum of the
    # FP deltas.  seg0 entries of empty segments may point past F — mask
    # them out before indexing.
    seg0 = _cumsum0(fn)[:-1]
    g = np.cumsum(fp)
    nz = fn > 0
    base_vals = np.zeros(len(fn), dtype=np.int64)
    if F:
        base_vals[nz] = g[seg0[nz]] - fp[seg0[nz]]
    fpos = g - np.repeat(base_vals, fn)

    unknown = ~np.isin(fc, np.fromiter(
        set(_OP_OF) | _NO_OP, dtype=np.uint8))
    if unknown.any():
        bad = chr(int(fc[unknown][0]))
        raise ValueError(f"unknown CRAM feature code {bad!r}")

    # per-code payloads (record order within each code)
    qcons = np.zeros(F, dtype=np.int64)      # query bases consumed
    oplen = np.zeros(F, dtype=np.int64)      # emitted op length
    opcode = np.full(F, -1, dtype=np.int64)  # emitted op (-1: none)
    for code, series in _ARR_SERIES.items():
        idx = np.flatnonzero(fc == code)
        if len(idx):
            _, _, lens = S.stop_items(series, len(idx))
            qcons[idx] = lens
            oplen[idx] = lens
            opcode[idx] = _OP_OF[code]
    for code, series in _LEN_SERIES.items():
        idx = np.flatnonzero(fc == code)
        if len(idx):
            oplen[idx] = S.ints(series, len(idx))
            opcode[idx] = _OP_OF[code]
    for code in _Q_ONE:
        idx = np.flatnonzero(fc == code)
        if len(idx):
            qcons[idx] = 1
            oplen[idx] = 1
            opcode[idx] = _OP_OF[code]

    # gap-fill M before each feature
    first = np.zeros(F, dtype=bool)
    if F:
        first[seg0[nz]] = True
    prev_end = np.empty(F, dtype=np.int64)
    if F:
        prev_end[1:] = fpos[:-1] + qcons[:-1]
        prev_end[first] = 1
    gap = fpos - prev_end
    if F and int(gap.min()) < 0:
        raise _Unsupported("unsorted features")

    # read position after the last feature, per mapped record
    last_end = np.ones(len(m_idx), dtype=np.int64)
    if F:
        seg_end = _cumsum0(fn)[1:] - 1
        has = fn > 0
        last_end[has] = fpos[seg_end[has]] + qcons[seg_end[has]]
    trailing = np.maximum(rl[m_idx] - last_end + 1, 0)

    # slot assembly: per mapped record [gap,op]*fn + trailing M
    slots_per = 2 * fn + 1
    slot0 = _cumsum0(slots_per)[:-1]
    S_total = int(slots_per.sum())
    ops_s = np.zeros(S_total, dtype=np.int64)
    lens_s = np.zeros(S_total, dtype=np.int64)
    rec_s = np.repeat(np.arange(len(m_idx)), slots_per)
    if F:
        rank = np.arange(F) - np.repeat(seg0, fn)
        gidx = np.repeat(slot0, fn) + 2 * rank
        lens_s[gidx] = gap                          # gap M (op 0)
        keepf = opcode >= 0
        ops_s[gidx[keepf] + 1] = opcode[keepf]
        lens_s[gidx[keepf] + 1] = oplen[keepf]
    lens_s[slot0 + 2 * fn] = trailing               # trailing M

    keep = lens_s > 0
    o, l, r = ops_s[keep], lens_s[keep], rec_s[keep]
    if len(o):
        new_run = np.empty(len(o), dtype=bool)
        new_run[0] = True
        new_run[1:] = (o[1:] != o[:-1]) | (r[1:] != r[:-1])
        run_id = np.cumsum(new_run) - 1
        m_len = np.bincount(run_id, weights=l).astype(np.int64)
        m_op = o[new_run]
        m_rec = r[new_run]
    else:
        m_len = np.zeros(0, np.int64)
        m_op = np.zeros(0, np.int64)
        m_rec = np.zeros(0, np.int64)

    per_mapped = np.bincount(m_rec, minlength=len(m_idx))
    per_rec = np.zeros(n, dtype=np.int64)
    per_rec[m_idx] = per_mapped
    return (m_op.astype(np.int8), m_len.astype(np.int32),
            _cumsum0(per_rec))
