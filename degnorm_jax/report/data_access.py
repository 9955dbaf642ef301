"""Post-hoc access to a DegNorm run directory's coverage data.

API mirrors reference ``data_access.py`` (SURVEY.md §2.1 #11):
``CoverageLoader``, ``get_coverage_plots``, ``get_coverage_data``.
Works against any run directory following the output contract —
including the reference's own, since file names/layout are identical.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

from degnorm_jax.report.visualizations import check_for_files, plot_gene_coverage


class CoverageLoader:
    """Loads raw + estimated coverage for named genes (case-insensitive,
    reference data_access.py:9-108)."""

    def __init__(self, data_dir: str):
        if not os.path.isdir(data_dir):
            raise NotADirectoryError(f"{data_dir} is not a directory")
        check_for_files(data_dir, ["gene_exon_metadata.csv",
                                   "read_counts.csv",
                                   "degradation_index_scores.csv"])
        self.data_dir = data_dir
        self.genes: List[str] = []
        self.sample_ids: List[str] = []
        self.exon_df: Optional[pd.DataFrame] = None
        self.cov_dict: Dict[str, Dict[str, np.ndarray]] = {}

    def load(self, genes: Union[str, Sequence[str]]):
        all_genes = isinstance(genes, str) and genes.lower() == "all"
        if isinstance(genes, str) and not all_genes:
            genes = [genes]

        self.exon_df = pd.read_csv(
            os.path.join(self.data_dir, "gene_exon_metadata.csv"),
            low_memory=False)
        # sample IDs come from the DI csv header (data_access.py:53-54)
        with open(os.path.join(self.data_dir,
                               "degradation_index_scores.csv")) as f:
            self.sample_ids = f.readline().strip().split(",")[2:]

        self.exon_df.gene = self.exon_df.gene.str.upper()
        if all_genes:
            self.genes = self.exon_df.gene.unique().tolist()
        else:
            self.genes = [g.upper() for g in genes]
            missing = set(self.genes) - set(self.exon_df.gene.unique())
            if missing:
                raise ValueError(
                    f"genes {sorted(missing)} not found in DegNorm output")
            self.exon_df = self.exon_df[self.exon_df.gene.isin(self.genes)]

        for chrom in self.exon_df.chr.unique():
            raw_f = os.path.join(self.data_dir, str(chrom),
                                 f"coverage_matrices_{chrom}.pkl")
            est_f = os.path.join(self.data_dir, str(chrom),
                                 f"estimated_coverage_matrices_{chrom}.pkl")
            if not os.path.exists(est_f):
                # estimates exist only for genes that reached NMF; a
                # chromosome whose genes were ALL filtered out (minimax
                # coverage / length) has metadata but no estimate pickle
                continue
            with open(raw_f, "rb") as fr, open(est_f, "rb") as fe:
                raw = {k.upper(): v for k, v in pickle.load(fr).items()}
                est = {k.upper(): v for k, v in pickle.load(fe).items()}
            for gene in self.exon_df[self.exon_df.chr == chrom].gene.unique():
                if gene in raw and gene in est:
                    self.cov_dict[gene] = {"raw": raw[gene],
                                           "estimate": est[gene]}
        if not all_genes:
            no_cov = [g for g in self.genes if g not in self.cov_dict]
            if no_cov:
                raise ValueError(
                    f"genes {sorted(no_cov)} have no estimated coverage in "
                    "this run (filtered out before NMF — see the pipeline's "
                    "minimax-coverage / length filters)")
        return self


def render_gene_figures(cov_dict, exon_df, sample_ids, figsize=(10, 6),
                        save_dir=None, n_jobs=None):
    """Render one before/after figure per gene in ``cov_dict``.

    When saving to disk, figures render CONCURRENTLY on a thread pool
    (the reference scatters plot genes across MPI ranks instead,
    __main_mpi__.py:461-488): plot_gene_coverage builds private OO-API
    figures with construction serialized under visualizations._FIG_LOCK,
    so the Agg rasterization and Pillow PNG encode (which releases the
    GIL) overlap across genes.  Figure-object mode stays serial (the
    returned figures' construction dominates anyway)."""
    items = list(cov_dict.items())

    def job(item):
        gene, dat = item
        gdf = exon_df[exon_df.gene == gene]
        return plot_gene_coverage(
            dat["estimate"], f=dat["raw"],
            x_exon=gdf[["start", "end"]].values, gene=gene,
            chrom=gdf.chr.iloc[0], sample_ids=sample_ids,
            save_dir=save_dir, figsize=figsize)

    if save_dir and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor
        n = n_jobs or min(len(items), os.cpu_count() or 2)
        with ThreadPoolExecutor(n) as ex:
            return list(ex.map(job, items))
    return [job(it) for it in items]


def get_coverage_plots(genes, degnorm_dir, figsize=(10, 6), save_dir=None,
                       n_jobs=None):
    """Before/after coverage figures for the named genes
    (data_access.py:111-172)."""
    ldr = CoverageLoader(degnorm_dir).load(genes)
    return render_gene_figures(ldr.cov_dict, ldr.exon_df, ldr.sample_ids,
                               figsize=figsize, save_dir=save_dir,
                               n_jobs=n_jobs)


def get_coverage_data(genes, degnorm_dir, save_dir=None):
    """Raw + estimated coverage as long (L_i x p) DataFrames; optionally
    written to save_dir/<chrom>/<gene>_{raw,estimated}_coverage.txt
    (data_access.py:175-260)."""
    ldr = CoverageLoader(degnorm_dir).load(genes)
    out: Dict[str, Dict[str, pd.DataFrame]] = {}
    for gene, dat in ldr.cov_dict.items():
        out[gene] = {
            "raw": pd.DataFrame(np.asarray(dat["raw"]).T,
                                columns=ldr.sample_ids),
            "estimate": pd.DataFrame(np.asarray(dat["estimate"]).T,
                                     columns=ldr.sample_ids),
        }
        if save_dir:
            chrom = str(ldr.exon_df[ldr.exon_df.gene == gene].chr.iloc[0])
            cdir = os.path.join(save_dir, chrom)
            os.makedirs(cdir, exist_ok=True)
            out[gene]["raw"].to_csv(
                os.path.join(cdir, f"{gene}_raw_coverage.txt"),
                index=False, sep=" ", float_format="%.5f")
            out[gene]["estimate"].to_csv(
                os.path.join(cdir, f"{gene}_estimated_coverage.txt"),
                index=False, sep=" ", float_format="%.5f")
    return out
