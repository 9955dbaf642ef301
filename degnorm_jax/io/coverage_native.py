"""ctypes front-end for the native coverage kernel
(io/native/coverage_kernel.cpp).

Marshals the pandas annotation into flat arrays, invokes
``dn_chrom_coverage``, and reshapes the outputs into the same
ChromCoverage contract as the numpy implementation.  Returns None when the
native path does not apply (no toolchain, strict mode, or missing pairing
hashes) so callers fall back transparently.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import pandas as pd

from degnorm_jax.io.bam import ReadColumns
from degnorm_jax.io.coverage import ChromCoverage


def _ptr(arr, ctype):
    if len(arr) == 0:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def chromosome_coverage_native(
    cols: ReadColumns,
    chrom: str,
    chrom_len: int,
    chrom_gene_df: pd.DataFrame,
    chrom_exon_df: pd.DataFrame,
    overlap_dat: Dict[str, list],
    *,
    paired: bool,
    unique_alignment: bool = True,
    n_threads: int = 1,
) -> Optional[ChromCoverage]:
    from degnorm_jax.io.native.build import load_library
    lib = load_library()
    if lib is None:
        return None
    if paired and cols.pair_hash is None:
        return None
    # reference parity (and kernel precondition): no-'M' CIGARs raise
    from degnorm_jax.io.coverage import check_compat_match_regions
    check_compat_match_regions(cols)

    genes = chrom_gene_df.gene.values
    n_genes = len(genes)
    gene_start0 = np.ascontiguousarray(
        chrom_gene_df.gene_start.values.astype(np.int64) - 1)
    gene_end0 = np.ascontiguousarray(
        chrom_gene_df.gene_end.values.astype(np.int64) - 1)

    gene_idx = {g: i for i, g in enumerate(genes)}
    gene_group = np.full(n_genes, -1, dtype=np.int32)
    groups = overlap_dat.get("overlap_genes", [])
    for gi, members in enumerate(groups):
        for g in members:
            if g in gene_idx:
                gene_group[gene_idx[g]] = gi

    # per-gene exon arrays in the reference's quirky convention
    # (sorted starts 0-indexed; sorted ends left 1-indexed).  Pure numpy:
    # one gene-code factorization + two lexsorts build every gene's
    # sorted segment in one shot — the previous pandas groupby
    # materialized 20k sub-DataFrames (~1.6 s of a 12.8 s single-sample
    # ETL at real annotation scale).  tx_positions (exon-union
    # coordinates) are only consumed for overlap-group genes below, so
    # isolated genes skip their arange/unique entirely.
    code_col = chrom_exon_df.gene.map(gene_idx)
    valid = code_col.notna().values
    codes = code_col.values[valid].astype(np.int64)
    e_starts = chrom_exon_df.start.values[valid].astype(np.int64)
    e_ends = chrom_exon_df.end.values[valid].astype(np.int64)
    counts = np.bincount(codes, minlength=n_genes)
    exon_offsets = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(counts, dtype=np.int64)])
    exon_starts0 = np.ascontiguousarray(
        e_starts[np.lexsort((e_starts, codes))] - 1)
    exon_ends1 = np.ascontiguousarray(e_ends[np.lexsort((e_ends, codes))])
    from degnorm_jax.io.gtf import exon_union_from_arrays
    tx_positions = [None] * n_genes
    for i in np.flatnonzero(gene_group >= 0):
        s0 = exon_starts0[exon_offsets[i]:exon_offsets[i + 1]]
        e1 = exon_ends1[exon_offsets[i]:exon_offsets[i + 1]]
        tx_positions[i] = exon_union_from_arrays(s0 + 1, e1)

    union_starts0 = np.ascontiguousarray(
        chrom_exon_df.start.values.astype(np.int64) - 1)
    union_ends1 = np.ascontiguousarray(
        chrom_exon_df.end.values.astype(np.int64))

    # overlap-gene coverage spans, concatenated
    span_off = [0]
    for i in range(n_genes):
        w = int(gene_end0[i] - gene_start0[i] + 1) if gene_group[i] >= 0 \
            else 0
        span_off.append(span_off[-1] + w)
    overlap_cov_offsets = np.asarray(span_off, np.int64)
    overlap_cov = np.zeros(span_off[-1], dtype=np.int64)

    has_isolated = bool(overlap_dat.get("isolated_genes"))
    iso_cov = np.zeros(chrom_len, np.int64) if has_isolated else None
    read_counts = np.zeros(n_genes, np.int64)

    pos = np.ascontiguousarray(cols.pos, np.int32)
    cops = np.ascontiguousarray(cols.cigar_ops, np.int8)
    clens = np.ascontiguousarray(cols.cigar_lens, np.int32)
    coffs = np.ascontiguousarray(cols.cigar_offsets, np.int64)
    nh = np.ascontiguousarray(cols.nh, np.int32)
    rnext = np.ascontiguousarray(cols.rnext, np.int32)
    phash = (np.ascontiguousarray(cols.pair_hash, np.uint64)
             if cols.pair_hash is not None else np.empty(0, np.uint64))

    rc = lib.dn_chrom_coverage(
        len(cols),
        _ptr(pos, ctypes.c_int32), _ptr(cops, ctypes.c_int8),
        _ptr(clens, ctypes.c_int32), _ptr(coffs, ctypes.c_int64),
        _ptr(nh, ctypes.c_int32), _ptr(rnext, ctypes.c_int32),
        _ptr(phash, ctypes.c_uint64),
        1 if paired else 0, 1 if unique_alignment else 0,
        chrom_len, n_genes,
        _ptr(gene_start0, ctypes.c_int64), _ptr(gene_end0, ctypes.c_int64),
        _ptr(gene_group, ctypes.c_int32),
        len(groups),
        _ptr(exon_offsets, ctypes.c_int64),
        _ptr(exon_starts0, ctypes.c_int64), _ptr(exon_ends1, ctypes.c_int64),
        len(union_starts0),
        _ptr(union_starts0, ctypes.c_int64), _ptr(union_ends1, ctypes.c_int64),
        _ptr(iso_cov, ctypes.c_int64) if iso_cov is not None else None,
        _ptr(overlap_cov, ctypes.c_int64),
        _ptr(overlap_cov_offsets, ctypes.c_int64),
        _ptr(read_counts, ctypes.c_int64),
        int(n_threads))
    if rc != 0:
        return None

    overlap_out = {}
    for i, g in enumerate(genes):
        if gene_group[i] < 0:
            continue
        span = overlap_cov[span_off[i]:span_off[i + 1]]
        overlap_out[g] = span[tx_positions[i] - gene_start0[i]]

    return ChromCoverage(
        chrom=chrom, isolated_coverage=iso_cov,
        overlap_coverage=overlap_out,
        read_counts={g: int(c) for g, c in zip(genes, read_counts)})
