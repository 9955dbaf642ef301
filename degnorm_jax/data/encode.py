"""Lossless compressed host->device coverage uploads.

Host->device bandwidth is a cost of engine start-up (PCIe transfer of
multi-GB coverage); whether this encoding still pays for itself against a
raw int16 upload on the GPU host is unmeasured (ROADMAP).  Read-pileup coverage
is integral and piecewise-smooth — adjacent positions differ by the number
of read starts/ends between them — so the position-axis deltas almost all
fit a few bits.  Two lossless forms, picked by ``encode_coverage``:

    int4: first column (int16) + nibble-packed deltas clipped to [-8, 7]
          (two per byte) + exception COO list — 1/4 of the int16 bytes.
          Measured 4-bit exception rates are <0.1% on pileup-like data.
    int8: same with byte deltas — the fallback when the input is not an
          int16 bucket or the 4-bit exception rate exceeds ~1%.

A single jitted device-side pass (unpack nibbles, scatter-add exceptions
into the widened deltas, cumulative-sum along positions) reconstructs the
exact int16 array once; kernels then cast per-step exactly as with direct
int16 uploads.  The int4 encoder has a single-pass C++ twin
(io/native/pack_kernel.cpp, byte-identical, ~50x the numpy encoder) — the
numpy form here stays the semantic source of truth.

Encoding is used only when exactly lossless and actually smaller
(integral values < 2^15, bounded exception rate).
"""
from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np


def int16able(F: np.ndarray) -> bool:
    """True when one array is exactly representable as int16 coverage:
    integral values in [0, 32766].  The single source of the eligibility
    rule shared by the int16 bucket packer (data/buckets.py), the engine's
    direct-upload fallback, and the delta encoder's validation.

    Float arrays take a single-pass native scan when the C++ library is
    available (the numpy form makes three full passes of transients; at
    50k-gene scale that is seconds of pure scan time)."""
    if F.dtype.kind == "b":
        return True
    if F.dtype.kind in "iu":
        return F.min(initial=0) >= 0 and F.max(initial=0) < 32767
    native = _int16able_native(F)
    if native is not None:
        return native
    return (F.min(initial=0.0) >= 0.0 and F.max(initial=0.0) < 32767
            and bool(np.all(F == np.floor(F))))


def int16able_many_native(mats, threads: int = 4) -> Optional[bool]:
    """Batched int16able scan over many arrays in ONE native call; None
    when any array is not a contiguous uniform-dtype float (caller falls
    back to the per-array path)."""
    if not mats:
        return True
    dt = mats[0].dtype
    if dt not in (np.float32, np.float64):
        return None
    if any(m.dtype != dt or not m.flags.c_contiguous for m in mats):
        return None
    from degnorm_jax.io.native.build import get_fn
    fn = get_fn("dn_int16able_many")
    if fn is None:
        return None
    import ctypes
    n = len(mats)
    ptrs = (ctypes.c_void_p * n)(*(m.ctypes.data for m in mats))
    sizes = np.fromiter((m.size for m in mats), np.int64, count=n)
    code = 0 if dt == np.float32 else 1
    return bool(fn(
        ptrs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, code, threads))


def _int16able_native(F: np.ndarray) -> Optional[bool]:
    """Native single-pass int16able scan for contiguous float arrays;
    None when unavailable (caller falls back to numpy)."""
    if F.dtype not in (np.float32, np.float64) or not F.flags.c_contiguous:
        return None
    from degnorm_jax.io.native.build import get_fn
    fn = get_fn("dn_f32_int16able" if F.dtype == np.float32
                else "dn_f64_int16able")
    if fn is None:
        return None
    import ctypes
    ptr_t = ctypes.POINTER(ctypes.c_float if F.dtype == np.float32
                           else ctypes.c_double)
    return bool(fn(F.ctypes.data_as(ptr_t), F.size))


class DeltaEncoded(NamedTuple):
    first: np.ndarray      # (G, p)   int16 — column 0
    deltas: np.ndarray     # (G, p, W-1) int8 — clipped position deltas
    exc_idx: np.ndarray    # (n,) int64 — flat indices into deltas (int64:
                           #   buckets on large-HBM parts exceed 2^31 elems)
    exc_val: np.ndarray    # (n,) int32 — true_delta - clipped_delta


def delta_encode(F: np.ndarray,
                 n_real: Optional[int] = None) -> Optional[DeltaEncoded]:
    """Encode an integral (G, p, W) coverage batch; None when ineligible.

    Works gene-slab-wise so the int32 transients stay bounded (~tens of MB)
    even for multi-GB buckets — the whole-array form would briefly allocate
    ~4x the bucket's bytes on the very path meant to cut transfer cost.
    Slabs are threaded (numpy ufuncs release the GIL).

    int16 input (buckets packed via integral_int16able) skips the
    integrality validation passes.  ``n_real`` marks how many leading genes
    are real: trailing padding genes are all-zero, so their encoder output
    rows are left as never-touched calloc pages (no write, no page fault).
    """
    if F.ndim != 3 or F.shape[2] < 2:
        return None
    G, p, W = F.shape
    g_enc = G if n_real is None else min(max(n_real, 0), G)
    slab = max(1, (64 << 20) // max(p * W * 4, 1))
    first = np.zeros((G, p), np.int16)
    deltas = np.zeros((G, p, W - 1), np.int8)
    row_stride = p * (W - 1)
    starts = list(range(0, g_enc, slab))
    parts: list = [None] * len(starts)
    exc_cap = 0.02 * max(g_enc, 1) * row_stride
    import threading
    exc_state = {"n": 0, "over": False}
    exc_lock = threading.Lock()

    def encode_slab(si):
        if exc_state["over"]:
            return False
        g0 = starts[si]
        g1 = min(g0 + slab, g_enc)
        Fs = F[g0:g1]
        if Fs.dtype.kind == "f":
            if not int16able(Fs):
                return False
            Fi = Fs.astype(np.int32)
        elif Fs.dtype in (np.int16, np.int32, np.int64):
            if Fs.max(initial=0) >= 32767 or Fs.min(initial=0) < 0:
                return False
            Fi = Fs     # int16 diffs cannot overflow int16
        else:           # unsigned/bool/etc: widen before signed delta math
            if not int16able(Fs):
                return False
            Fi = Fs.astype(np.int32)
        d = np.diff(Fi, axis=2)
        clipped = np.clip(d, -128, 127)
        exc = d != clipped
        # incremental eligibility: stop materializing COO transients once
        # the cumulative exception rate is already past the 2% cap (keeps
        # the docstring's bounded-transient promise for ineligible input)
        n_here = int(exc.sum())
        with exc_lock:
            exc_state["n"] += n_here
            if exc_state["n"] > exc_cap:
                exc_state["over"] = True
                return False
        idx = np.flatnonzero(exc)
        parts[si] = (
            (idx + g0 * row_stride).astype(np.int64),
            (d.reshape(-1)[idx].astype(np.int32)
             - clipped.reshape(-1)[idx].astype(np.int32)),
        )
        first[g0:g1] = Fi[:, :, 0]
        deltas[g0:g1] = clipped.astype(np.int8)
        return True

    with ThreadPoolExecutor(min(4, max(1, len(starts)))) as ex:
        if not all(ex.map(encode_slab, range(len(starts)))):
            return None
    return DeltaEncoded(
        first=first,
        deltas=deltas,
        exc_idx=(np.concatenate([ip for ip, _ in parts]) if parts
                 else np.empty(0, np.int64)),
        exc_val=(np.concatenate([vp for _, vp in parts]) if parts
                 else np.empty(0, np.int32)),
    )


class NibEncoded(NamedTuple):
    """4-bit delta form: two clipped position deltas per byte (low nibble =
    even delta index), exceptions as a COO list — half the int8-delta bytes
    at typical pileup smoothness (4-bit exception rates measured <0.1% on
    both synthetic and simulated-read coverage)."""
    first: np.ndarray      # (G, p)  int16 — column 0
    nib: np.ndarray        # (G, p, ceil((W-1)/2)) uint8 — packed deltas
    exc_idx: np.ndarray    # (n,) int64 — flat indices into (G, p, W-1)
    exc_val: np.ndarray    # (n,) int32 — true_delta - clipped_delta
    Wm1: int               # W-1 (the packed axis drops the odd tail nibble)


def _nib_exc_cap(n_deltas: int) -> int:
    """Exception-buffer size for the nibble encoder: past ~1% exceptions
    the data is not pileup-smooth and the int8 form is the right encoding
    anyway (break-even vs int8 is ~4%: each exception costs 12 COO bytes
    against the 0.5 byte/delta saving)."""
    return max(1024, n_deltas // 100)


def nibble_encode(F: np.ndarray,
                  n_real: Optional[int] = None) -> Optional[NibEncoded]:
    """numpy 4-bit delta encoder for int16 (G, p, W) buckets — the semantic
    reference for the native kernel (pack_kernel.cpp) and the portable
    fallback.  None when W < 2 or the exception rate exceeds the cap.
    Slab-wise over genes to bound transients, like delta_encode.

    ``n_real`` marks how many leading genes are real; genes beyond it are
    NOT encoded and decode to zeros — callers must only pass buckets whose
    trailing padding genes are all-zero (data/buckets.py guarantees this)."""
    if F.ndim != 3 or F.shape[2] < 2 or F.dtype != np.int16:
        return None
    G, p, W = F.shape
    Wm1 = W - 1
    nb = (Wm1 + 1) // 2
    g_enc = G if n_real is None else min(max(n_real, 0), G)
    first = np.zeros((G, p), np.int16)
    nib = np.zeros((G, p, nb), np.uint8)
    row_stride = p * Wm1
    cap = _nib_exc_cap(g_enc * row_stride)
    slab = max(1, (64 << 20) // max(p * W * 4, 1))
    idx_parts, val_parts = [], []
    n_exc = 0
    for g0 in range(0, g_enc, slab):
        g1 = min(g0 + slab, g_enc)
        Fs = F[g0:g1]
        d = np.diff(Fs.astype(np.int32), axis=2)
        c = np.clip(d, -8, 7)
        exc = d != c
        n_exc += int(exc.sum())
        if n_exc > cap:
            return None
        idx = np.flatnonzero(exc)
        idx_parts.append((idx + g0 * row_stride).astype(np.int64))
        val_parts.append(d.reshape(-1)[idx] - c.reshape(-1)[idx])
        if Wm1 & 1:
            c = np.concatenate(
                [c, np.zeros(c.shape[:2] + (1,), c.dtype)], axis=2)
        cu = (c & 0xF).astype(np.uint8)
        nib[g0:g1] = cu[:, :, 0::2] | (cu[:, :, 1::2] << 4)
        first[g0:g1] = Fs[:, :, 0]
    return NibEncoded(
        first=first, nib=nib,
        exc_idx=(np.concatenate(idx_parts) if idx_parts
                 else np.empty(0, np.int64)),
        exc_val=(np.concatenate(val_parts).astype(np.int32) if val_parts
                 else np.empty(0, np.int32)),
        Wm1=Wm1)


# Sentinel: the native encoder ran and REJECTED the bucket (exception rate
# over cap) — distinct from "library unavailable" (None), so dispatch can
# skip the numpy re-scan that would reach the identical cap.
OVER_CAP = object()


def nibble_encode_native(F: np.ndarray,
                         n_real: Optional[int] = None,
                         threads: int = 0):
    """Single-pass C++ twin of nibble_encode (byte-identical output).
    Returns a NibEncoded, None when the library is unavailable or the
    input ineligible, or OVER_CAP when the encoder ran and the exception
    rate exceeded the cap (the numpy encoder would reject it too)."""
    if F.ndim != 3 or F.shape[2] < 2 or F.dtype != np.int16:
        return None
    if not F.flags.c_contiguous:
        return None
    from degnorm_jax.io.native.build import get_fn
    fn = get_fn("dn_nib_encode")
    if fn is None:
        return None
    import ctypes
    G, p, W = F.shape
    Wm1 = W - 1
    g_enc = G if n_real is None else min(max(n_real, 0), G)
    cap = _nib_exc_cap(g_enc * p * Wm1)
    first = np.zeros((G, p), np.int16)
    nib = np.zeros((G, p, (Wm1 + 1) // 2), np.uint8)
    exc_idx = np.empty(cap, np.int64)
    exc_val = np.empty(cap, np.int32)
    if not threads:
        threads = min(4, os.cpu_count() or 1)
    i16 = ctypes.POINTER(ctypes.c_int16)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    n = int(fn(
        F.ctypes.data_as(i16), g_enc, p, W,
        first.ctypes.data_as(i16), nib.ctypes.data_as(u8),
        exc_idx.ctypes.data_as(i64), exc_val.ctypes.data_as(i32),
        cap, threads))
    if n < 0:
        return OVER_CAP
    return NibEncoded(first=first, nib=nib, exc_idx=exc_idx[:n].copy(),
                      exc_val=exc_val[:n].copy(), Wm1=Wm1)


def encode_coverage(F: np.ndarray, n_real: Optional[int] = None):
    """Best lossless compressed upload form for one packed bucket:
    4-bit deltas (native, then numpy) for int16 buckets, int8 deltas
    otherwise; None when nothing applies (caller uploads directly)."""
    if F.ndim != 3 or F.shape[2] < 2:
        return None
    if F.dtype == np.int16:
        enc = nibble_encode_native(F, n_real)
        if enc is None:               # library unavailable -> numpy twin
            enc = nibble_encode(F, n_real)
        if isinstance(enc, NibEncoded):
            return enc
        # OVER_CAP / numpy None: the 4-bit form is not profitable —
        # fall through to int8 deltas without re-scanning as nibble.
    return delta_encode(F, n_real=n_real)


def decode_coverage_device(enc):
    """Reconstruct the exact int16 (G, p, W) device array from either
    encoded form (dispatch counterpart of encode_coverage).  Fields are
    handed over as host arrays — the decoders split the int64 exception
    indices on host before any device transfer (see _exc_row_col)."""
    if isinstance(enc, NibEncoded):
        return nib_decode_device(enc.first, enc.nib, enc.exc_idx,
                                 enc.exc_val, enc.Wm1)
    return delta_decode_device(enc.first, enc.deltas, enc.exc_idx,
                               enc.exc_val)


def _exc_row_col(exc_idx, Wm1: int):
    """Split flat (G, p, W-1)-space exception indices into int32
    (row, column) pairs ON HOST.  The flat form can exceed 2^31 on
    large-HBM parts, and without jax_enable_x64 (the production default)
    jnp.asarray would silently truncate int64 -> int32, scattering
    exceptions to wrong positions.  Rows (G*p) and columns (W-1) are each
    far below 2^31 individually."""
    exc_idx = np.asarray(exc_idx)
    return ((exc_idx // Wm1).astype(np.int32),
            (exc_idx % Wm1).astype(np.int32))


def nib_decode_device(first, nib, exc_idx, exc_val, Wm1: int):
    """Unpack + reconstruct the exact int16 (G, p, W) array on device."""
    import jax.numpy as jnp
    row, col = _exc_row_col(exc_idx, Wm1)
    return _nib_decode_jit(jnp.asarray(np.asarray(first)),
                           jnp.asarray(np.asarray(nib)),
                           jnp.asarray(row), jnp.asarray(col),
                           jnp.asarray(np.asarray(exc_val)), Wm1)


@functools.partial(__import__("jax").jit, static_argnames=("Wm1",))
def _nib_decode_jit(first, nib, exc_row, exc_col, exc_val, Wm1: int):
    import jax.numpy as jnp
    G, p, nb = nib.shape
    b = nib.astype(jnp.int32)
    lo = b & 0xF
    hi = b >> 4
    lo = jnp.where(lo > 7, lo - 16, lo)
    hi = jnp.where(hi > 7, hi - 16, hi)
    d = jnp.stack([lo, hi], axis=-1).reshape(G, p, 2 * nb)[:, :, :Wm1]
    d = d.reshape(G * p, Wm1).at[exc_row, exc_col].add(exc_val)
    d = d.reshape(G, p, Wm1)
    full = jnp.concatenate([first.astype(jnp.int32)[:, :, None], d], axis=2)
    return jnp.cumsum(full, axis=2).astype(jnp.int16)


def delta_decode_device(first, deltas, exc_idx, exc_val):
    """Reconstruct the exact int16 (G, p, W) array on device."""
    import jax.numpy as jnp
    row, col = _exc_row_col(exc_idx, np.asarray(deltas).shape[2])
    return _delta_decode_jit(jnp.asarray(np.asarray(first)),
                             jnp.asarray(np.asarray(deltas)),
                             jnp.asarray(row), jnp.asarray(col),
                             jnp.asarray(np.asarray(exc_val)))


@functools.partial(__import__("jax").jit, static_argnames=())
def _delta_decode_jit(first, deltas, exc_row, exc_col, exc_val):
    import jax.numpy as jnp
    G, p, Wm1 = deltas.shape
    d = deltas.astype(jnp.int32).reshape(G * p, Wm1)
    d = d.at[exc_row, exc_col].add(exc_val)
    d = d.reshape(G, p, Wm1)
    full = jnp.concatenate([first.astype(jnp.int32)[:, :, None], d], axis=2)
    return jnp.cumsum(full, axis=2).astype(jnp.int16)
