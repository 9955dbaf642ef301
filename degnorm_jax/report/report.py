"""HTML (optionally PDF) pipeline summary report.

API mirrors reference ``report.py:9-155``: parameter/input tables, DI
distribution plots, top/bottom-N mean-DI gene coverage figures, Jinja2
template render, optional pandoc HTML->PDF conversion.
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
from datetime import datetime
from typing import Dict, Sequence

import numpy as np
import pandas as pd

from degnorm_jax.report.data_access import get_coverage_plots
from degnorm_jax.report.visualizations import (
    di_frame, get_di_boxplots, get_di_correlation, get_di_heatmap)

log = logging.getLogger("degnorm_jax")

RESOURCES_DIR = os.path.join(os.path.dirname(__file__), "resources")


def render_report(data_dir: str, degnorm_data: Dict, bam_files: Sequence[str],
                  sample_ids: Sequence[str], top_n_genes: int = 5,
                  output_dir: str = ".", cov_data: Dict = None,
                  exon_df: pd.DataFrame = None) -> str:
    """Render report/degnorm_summary.html (+ .pdf when pandoc exists).

    ``cov_data``: optional in-memory ``{"raw": {gene: p x L}, "estimate":
    {gene: p x L}}`` (with ``exon_df``) — the pipeline passes the arrays it
    already holds so the top/bottom-N coverage figures skip re-unpickling
    the per-chromosome coverage artifacts it just wrote (at 20k genes the
    double CoverageLoader pass was ~1.5 s of the report phase)."""
    from jinja2 import Environment, FileSystemLoader

    report_dir = os.path.join(output_dir, "report")
    os.makedirs(report_dir, exist_ok=True)

    # input-file table (report.py:30-38)
    warm = len(bam_files) == 1 and os.path.isdir(bam_files[0])
    files_df = pd.DataFrame(
        {"Warm-start directory" if warm else "Input file": list(bam_files),
         "Sample ID": list(sample_ids)[:len(bam_files)]
         if warm else list(sample_ids)})

    rho = np.asarray(degnorm_data["rho"])
    genes = list(degnorm_data["genes"])
    params_df = pd.DataFrame({
        "NMF-OA SVD iterations": [degnorm_data.get("nmf_iter")],
        "DegNorm iterations": [degnorm_data.get("degnorm_iter")],
        "Downsample rate": [f"1/{degnorm_data.get('downsample_rate')}"],
        "Number of input genes": [len(genes)],
    }).T.rename(columns={0: "value"})

    # top/bottom-N mean-DI gene selection (report.py:97-113)
    n = min(top_n_genes, len(genes))
    order = np.argsort(rho.mean(axis=1))
    lo_genes = [genes[i] for i in order[:n]]
    hi_genes = [genes[i] for i in order[::-1][:n]]

    # All figures render CONCURRENTLY: the three DI graphics and the 2N
    # gene coverage figures are independent OO-API figures (thread-safe
    # construction under visualizations._FIG_LOCK); the reference renders
    # every one serially (report.py:49-113).
    from concurrent.futures import ThreadPoolExecutor

    def _gene_figs():
        try:
            if cov_data is not None and exon_df is not None:
                from degnorm_jax.report.data_access import \
                    render_gene_figures
                sub = {g: {"raw": np.asarray(cov_data["raw"][g]),
                           "estimate": np.asarray(cov_data["estimate"][g])}
                       for g in hi_genes + lo_genes}
                imgs = render_gene_figures(
                    sub, exon_df, list(sample_ids), save_dir=data_dir)
            else:
                # ONE loader pass for both gene sets (was two full
                # per-chromosome unpickle sweeps)
                imgs = get_coverage_plots(hi_genes + lo_genes,
                                          degnorm_dir=data_dir,
                                          save_dir=data_dir)
            # returned paths follow the renderer's iteration order; match
            # them back to the hi/lo sets by the <GENE>_coverage.png
            # basename (the loader path upper-cases gene names)
            by = {os.path.basename(p).upper(): p for p in imgs}

            def find(g):
                return by.get(f"{g}_coverage.png".upper())

            return ([p for p in map(find, hi_genes) if p],
                    [p for p in map(find, lo_genes) if p])
        except Exception as e:
            log.warning("coverage plots for report failed: %s", e)
            return [], []

    # DI frame straight from the in-memory rho: no dependency on the
    # just-written CSV (which lets the whole report render concurrently
    # with the save phase, pipeline/run.py)
    rho_df = di_frame(rho, genes, sample_ids, order=True)
    plots = {}
    with ThreadPoolExecutor(4) as ex:
        gene_future = ex.submit(_gene_figs)
        # DI plots need >1 gene and nontrivial rank (report.py:52-55)
        if rho.shape[0] > 1 and np.linalg.matrix_rank(rho) > 1:
            futs = {
                "di_boxplots": ex.submit(get_di_boxplots, data_dir,
                                         save_dir=report_dir,
                                         rho_df=rho_df),
                "di_heatmap": ex.submit(get_di_heatmap, data_dir,
                                        save_dir=report_dir,
                                        rho_df=rho_df),
                "di_correlation": ex.submit(get_di_correlation, data_dir,
                                            save_dir=report_dir,
                                            rho_df=rho_df),
            }
            for k, f in futs.items():
                plots[k] = f.result()
        hi_imgs, lo_imgs = gene_future.result()

    env = Environment(loader=FileSystemLoader(RESOURCES_DIR))
    html = env.get_template("degnorm_report.html").render(
        timestamp=datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        files_table=files_df.to_html(index=False),
        params_table=params_df.to_html(header=False),
        di_boxplots=plots.get("di_boxplots"),
        di_heatmap=plots.get("di_heatmap"),
        di_correlation=plots.get("di_correlation"),
        hi_di_imgs=hi_imgs, lo_di_imgs=lo_imgs, top_n=n)

    html_path = os.path.join(report_dir, "degnorm_summary.html")
    with open(html_path, "w") as f:
        f.write(html)

    # optional pandoc HTML -> PDF (report.py:146-155)
    if shutil.which("pandoc"):
        pdf_path = os.path.join(report_dir, "degnorm_summary.pdf")
        try:
            subprocess.run(["pandoc", html_path, "-o", pdf_path],
                           check=True, capture_output=True, timeout=120)
            return pdf_path
        except Exception as e:
            log.warning("pandoc conversion failed: %s", e)
    return html_path
