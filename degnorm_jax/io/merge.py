"""Cross-sample merge: per-(sample, chromosome) ETL artifacts -> the
(n x p) read-count matrix and the {gene: (p x L_i)} coverage dictionary.

Replaces reference ``reads_coverage_merge.py`` (SURVEY.md §2.1 #7).  The
reference round-trips everything through per-sample files and re-loads
them in ~500 MB dense slices; here the per-sample results stream in memory
(with optional reference-layout artifact writing for resume/compat —
pipeline/outputs.py).

Contract preserved:
  * isolated genes' matrices are sliced from whole-chromosome coverage at
    exon-union positions (reads_coverage_merge.py:333-353);
  * overlap genes' per-gene vectors stack directly
    (reads_coverage_merge.py:93-164);
  * a sample with no data for a chromosome contributes a zero row
    (reads_coverage_merge.py:305-312);
  * isolated genes on chromosomes with no coverage in ANY sample are
    dropped from the coverage set (reads_coverage_merge.py:227-239).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Sequence

import numpy as np
import pandas as pd

from degnorm_jax.io.coverage import ChromCoverage
from degnorm_jax.io.gtf import exon_union_from_arrays


def merge_read_counts(
    results: Mapping[str, Mapping[str, ChromCoverage]],
    sample_ids: Sequence[str],
    chroms: Sequence[str],
) -> pd.DataFrame:
    """Merge per-sample counts into a [chr, gene, <sample_ids>] DataFrame
    (reference merge_read_counts, reads_coverage_merge.py:13-90)."""
    frames = []
    for chrom in chroms:
        cols: Dict[str, List] = {}
        genes = None
        for sid in sample_ids:
            cc = results[sid][chrom]
            if genes is None:
                genes = list(cc.read_counts.keys())
            cols[sid] = [cc.read_counts[g] for g in genes]
        df = pd.DataFrame({"chr": chrom, "gene": genes, **cols})
        frames.append(df[["chr", "gene"] + list(sample_ids)])
    return pd.concat(frames, ignore_index=True)


def merge_coverage(
    results: Mapping[str, Mapping[str, ChromCoverage]],
    sample_ids: Sequence[str],
    exon_df: pd.DataFrame,
) -> "OrderedDict[str, np.ndarray]":
    """Merge per-sample coverage into {gene: (p x L_i)} float arrays.

    Genes are emitted per chromosome (exon_df chromosome order), isolated
    genes first (ordered by gene_end, like the reference's memory-chunked
    sweep) then overlap-group genes.
    """
    gene_cov: "OrderedDict[str, np.ndarray]" = OrderedDict()
    p = len(sample_ids)

    for chrom in exon_df.chr.unique():
        cdf = exon_df[exon_df.chr == chrom]
        per_sample = [results[sid].get(chrom) for sid in sample_ids]

        # per-gene exon segments in one factorize pass: the former
        # per-gene `cdf[cdf.gene == gene]` boolean filter was
        # O(genes x exons) per chromosome and dominated the merge at
        # real annotation scale (25.8 s for 2 samples x 20k genes)
        codes, uniq = pd.factorize(cdf.gene)
        c_starts = cdf.start.values.astype(np.int64)
        c_ends = cdf.end.values.astype(np.int64)
        order = np.argsort(codes, kind="stable")
        counts = np.bincount(codes, minlength=len(uniq))
        offs = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts, dtype=np.int64)])
        s_sorted, e_sorted = c_starts[order], c_ends[order]
        seg = {g: (s_sorted[offs[i]:offs[i + 1]],
                   e_sorted[offs[i]:offs[i + 1]])
               for i, g in enumerate(uniq)}

        # ---- emission order mirrors the reference EXACTLY: all genes of
        # the chromosome sorted by gene_end (stable over exon-row order,
        # reads_coverage_merge.py:248-252) — the reference's isolated
        # slicing loop emits EVERY gene in that order and the overlap
        # dict merge `{**iso, **overlap}` only overwrites VALUES, keeping
        # the gene_end-slot positions (merge_coverage:432).  The twin-run
        # artifact diff (tests/test_twin_run.py) pins this contract.
        any_iso = any(cc is not None and cc.isolated_coverage is not None
                      for cc in per_sample)
        gene_end_order = cdf.sort_values(
            "gene_end", kind="stable").gene.unique().tolist()
        overlap_genes_present = set()
        overlap_insert_order = []
        for cc in per_sample:
            if cc is not None:
                for g in cc.overlap_coverage:
                    if g not in overlap_genes_present:
                        overlap_genes_present.add(g)
                        overlap_insert_order.append(g)

        def _emit_overlap(gene):
            rows = []
            L = None
            for cc in per_sample:
                v = None if cc is None else cc.overlap_coverage.get(gene)
                if v is not None:
                    L = len(v)
            if L is None:
                return
            for cc in per_sample:
                v = None if cc is None else cc.overlap_coverage.get(gene)
                rows.append(np.zeros(L) if v is None else v.astype(float))
            gene_cov[gene] = np.vstack(rows)

        if any_iso:
            for gene in gene_end_order:
                if gene in overlap_genes_present:
                    _emit_overlap(gene)
                    continue
                s, e = seg[gene]
                tx = exon_union_from_arrays(s, e)
                rows = []
                for cc in per_sample:
                    if cc is None or cc.isolated_coverage is None:
                        rows.append(np.zeros(len(tx)))
                    else:
                        rows.append(cc.isolated_coverage[tx].astype(float))
                gene_cov[gene] = np.vstack(rows)
        else:
            # no chromosome coverage at all: the reference's iso dict is
            # empty, so only overlap genes appear — in ETL insertion order
            for gene in overlap_insert_order:
                _emit_overlap(gene)

    return gene_cov
