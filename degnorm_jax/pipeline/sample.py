"""Per-sample BAM ETL driver — the BamReadsProcessor equivalent
(reference ``reads.py:95-847``) built on the dependency-free io/ stack.
"""
from __future__ import annotations

import logging
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import pandas as pd

from degnorm_jax.io import bam as bamio
from degnorm_jax.io.coverage import ChromCoverage, chromosome_coverage_read_counts

log = logging.getLogger("degnorm_jax")


class BamSampleProcessor:
    """Loads one .bam or .cram, sniffs pairedness, and computes
    per-chromosome coverage + read counts.

    CRAM input is a completeness extension over the reference (which only
    accepts .bam through pysam, ``loaders.py:44-70``): files ending in
    .cram decode through io/cram.py — whole-file, reference-FASTA-free —
    and flow into the identical columnar coverage path."""

    #: default whole-file decode threshold for auto streaming (bytes).
    STREAM_THRESHOLD = 512 << 20

    def __init__(self, bam_file: str, chroms: Optional[Sequence[str]] = None,
                 unique_alignment: bool = True, output_dir: Optional[str] = None,
                 compat: str = "reference", bai_file: Optional[str] = None,
                 stream: Optional[bool] = None):
        """``stream``: fetch reads per chromosome through the .bai index
        (memory-bounded; reference-equivalent of pysam's indexed fetch,
        reads.py:225) instead of decoding the whole BAM up front.  None =
        auto: stream when an index exists and the file exceeds
        ``STREAM_THRESHOLD``."""
        self.filename = bam_file
        self.sample_id = ".".join(os.path.basename(bam_file).split(".")[:-1])
        self.unique_alignment = unique_alignment
        self.compat = compat
        self.output_dir = output_dir
        self.save_dir = (os.path.join(output_dir, self.sample_id)
                         if output_dir else None)
        self.is_cram = bam_file.lower().endswith(".cram")

        if self.is_cram:
            # CRAM needs no index to stream: containers carry their ref
            # id, so per-chromosome fetch is seek-and-skip (io/cram.py::
            # read_cram_region).  Same auto rule as BAM.
            from degnorm_jax.io import cram as cramio
            self.bai_file = None
            self._bai_index = None
            if stream is None:
                stream = os.path.getsize(bam_file) > self.STREAM_THRESHOLD
            self.stream = bool(stream)
            self.header = cramio.read_cram_header(bam_file)
            names = self.header.ref_names
            if chroms is not None:
                names = [c for c in names if c in set(chroms)]
            self.chroms = names
            self._cols_by_tid: Dict[int, bamio.ReadColumns] = {}
            self.paired = self._sniff_paired()
            return

        if bai_file is None:
            for cand in (bam_file + ".bai",
                         os.path.splitext(bam_file)[0] + ".bai"):
                if os.path.isfile(cand):
                    bai_file = cand
                    break
        if stream is None:
            stream = os.path.getsize(bam_file) > self.STREAM_THRESHOLD
        if stream and bai_file is None:
            # native samtools-index equivalent (reference utils.py:149-173)
            from degnorm_jax.io.bai import index_bam
            log.info("SAMPLE %s: building missing .bai index", self.sample_id)
            bai_file = index_bam(bam_file)
        self.bai_file = bai_file
        self.stream = bool(stream and bai_file is not None)
        self._bai_index = None

        self.header = bamio.read_header(bam_file)
        names = self.header.ref_names
        if chroms is not None:
            names = [c for c in names if c in set(chroms)]
        self.chroms = names
        self._cols_by_tid: Dict[int, bamio.ReadColumns] = {}
        self.paired = self._sniff_paired()

    @property
    def header_df(self) -> pd.DataFrame:
        return self.header.as_frame()

    def _load_all(self):
        if not self._cols_by_tid:
            if self.is_cram:
                from degnorm_jax.io import cram as cramio
                _, cols = cramio.read_cram(self.filename)
            else:
                _, cols = bamio.read_bam(self.filename)
            for t in np.unique(cols.tid):
                self._cols_by_tid[int(t)] = bamio.subset_columns(
                    cols, cols.tid == t)

    def _sniff_paired(self) -> bool:
        """Pairedness heuristic from the first 301 query names in file
        order: all qnames end in '.1'/'.2' (reference reads.py:178-203,
        which heads the loaded reads dataframe — file order likewise).
        The sniff reads BGZF blocks/containers incrementally from the file
        head in BOTH modes, so __init__ never triggers a whole-file decode
        (non-stream decode is deferred to coverage_read_counts, inside the
        per-sample thread pool)."""
        if self.is_cram:
            from degnorm_jax.io import cram as cramio
            qnames = cramio.read_cram_head_qnames(self.filename, 301)
        else:
            qnames = bamio.read_head_qnames(self.filename, 301)
        if not qnames:
            return False
        return {q.split(".")[-1] for q in qnames} == {"1", "2"}

    def _chrom_cols(self, tid: int) -> bamio.ReadColumns:
        if self.stream and self.is_cram:
            from degnorm_jax.io import cram as cramio
            return cramio.read_cram_region(self.filename, tid)
        if self.stream:
            from degnorm_jax.io import bai as baiio
            if self._bai_index is None:
                self._bai_index = baiio.read_bai(self.bai_file)
            blob = baiio.fetch_region_bytes(
                self.filename, self._bai_index, tid, 0,
                self.header.ref_lengths[tid])
            return bamio.parse_region_blob(blob, tid=tid)
        self._load_all()
        cols = self._cols_by_tid.get(tid)
        return cols if cols is not None else _empty_cols()

    def chromosome_coverage(self, chrom: str, chrom_gene_df, chrom_exon_df,
                            overlap_dat,
                            n_threads: int = 1) -> ChromCoverage:
        tid = self.header.ref_names.index(chrom)
        chrom_len = self.header.ref_lengths[tid]
        cols = self._chrom_cols(tid)
        return chromosome_coverage_read_counts(
            cols, chrom, chrom_len, chrom_gene_df, chrom_exon_df,
            overlap_dat, paired=self.paired,
            unique_alignment=self.unique_alignment, compat=self.compat,
            n_threads=n_threads)

    def coverage_read_counts(self, overlap_by_chrom: Mapping[str, dict],
                             gene_df: pd.DataFrame, exon_df: pd.DataFrame,
                             n_jobs: int = 1) -> Dict[str, ChromCoverage]:
        """All chromosomes (threaded), optionally persisting reference-layout
        artifacts for resume (reads.py:368-386 semantics)."""
        if not self.stream:
            # decode the whole file only if some chromosome actually needs
            # computing: when every (sample, chrom) artifact already exists
            # (mid-ETL resume, or a multihost peer's shard on the shared
            # filesystem) this call is a pure load
            if any(not (self.save_dir and self._artifacts_exist(c))
                   for c in self.chroms):
                self._load_all()
        results: Dict[str, ChromCoverage] = {}

        # IN-CHROMOSOME threading (round 5): when there are fewer
        # chromosomes than cores (the limit case being single-contig
        # datasets, e.g. the reference's own chr1-only test data), the
        # spare cores thread INSIDE the C++ coverage kernel — atomic
        # integer accumulation, bit-identical to the serial kernel — so
        # one contig no longer caps ETL at one core.  The reference only
        # ever threads per chromosome (reads.py:840-847).
        chrom_workers = min(max(n_jobs, 1), max(len(self.chroms), 1))
        kernel_threads = max(1, n_jobs // chrom_workers)

        def work(chrom):
            if self.save_dir and self._artifacts_exist(chrom):
                return chrom, self._load_artifacts(chrom)
            cc = self.chromosome_coverage(
                chrom,
                gene_df[gene_df.chr == chrom],
                exon_df[exon_df.chr == chrom],
                overlap_by_chrom[chrom],
                n_threads=kernel_threads)
            if self.save_dir:
                self._save_artifacts(cc)
            return chrom, cc

        try:
            if chrom_workers > 1 and len(self.chroms) > 1:
                with ThreadPoolExecutor(max_workers=chrom_workers) as ex:
                    for chrom, cc in ex.map(work, self.chroms):
                        results[chrom] = cc
            else:
                for chrom in self.chroms:
                    _, results[chrom] = work(chrom)
        finally:
            # The per-tid column cache exists so every chromosome of THIS
            # pass shares one whole-file decode; holding it beyond the
            # pass pinned each sample's full column set (~1.6 GB at 20M
            # reads) on the long-lived processor for the rest of the run
            # — measured to degrade later samples' ETL ~2x through memory
            # pressure (single-chrom files cache the original native
            # buffers via the all-True subset fast path).
            self._cols_by_tid = {}
        return results

    # -- reference-layout per-(sample,chrom) artifacts -------------------
    def _paths(self, chrom):
        sid = self.sample_id
        return (
            os.path.join(self.save_dir, f"chrom_coverage_{sid}_{chrom}.npz"),
            os.path.join(self.save_dir, f"overlap_coverage_{sid}_{chrom}.pkl"),
            os.path.join(self.save_dir, f"read_counts_{sid}_{chrom}.csv"),
        )

    def _artifacts_exist(self, chrom) -> bool:
        # the csv is written LAST in _save_artifacts, so its presence
        # implies the npz/pkl (when the chromosome produced any coverage)
        # are complete; a chromosome with zero isolated AND zero overlap
        # coverage legitimately has only the csv (merge imputes zeros,
        # like the reference's missing-sample-file rule,
        # reads_coverage_merge.py:305-312)
        _, _, csv = self._paths(chrom)
        return os.path.isfile(csv)

    def _save_artifacts(self, cc: ChromCoverage) -> None:
        from scipy import sparse
        os.makedirs(self.save_dir, exist_ok=True)
        npz, pkl_f, csv = self._paths(cc.chrom)
        if cc.isolated_coverage is not None:
            m = sparse.csr_matrix(cc.isolated_coverage)
            # pileup counts are small ints: int32 data halves the bytes and
            # skipping DEFLATE removes the dominant ETL artifact-write cost
            # (zlib was 4.1 s of a 12.8 s single-sample ETL at 20k genes —
            # these are in-run scratch files, deleted after the merge; the
            # .npz container format and load path are unchanged)
            if m.data.size == 0 or (0 <= m.data.min()
                                    and m.data.max() < 2 ** 31):
                m = m.astype(np.int32)
            sparse.save_npz(npz, m, compressed=False)
        if cc.overlap_coverage:
            with open(pkl_f, "wb") as f:
                pickle.dump(cc.overlap_coverage, f)
        pd.DataFrame({"gene": list(cc.read_counts.keys()),
                      self.sample_id: list(cc.read_counts.values())}
                     ).to_csv(csv, index=False)

    def _load_artifacts(self, chrom) -> ChromCoverage:
        from scipy import sparse
        npz, pkl_f, csv = self._paths(chrom)
        iso = None
        if os.path.isfile(npz):
            iso = np.asarray(sparse.load_npz(npz).todense()).ravel()
        ol = {}
        if os.path.isfile(pkl_f):
            with open(pkl_f, "rb") as f:
                ol = pickle.load(f)
        cnt = pd.read_csv(csv)
        counts = dict(zip(cnt.gene, cnt[self.sample_id]))
        return ChromCoverage(chrom=chrom, isolated_coverage=iso,
                             overlap_coverage=ol, read_counts=counts)




def _empty_cols() -> bamio.ReadColumns:
    return bamio.ReadColumns(
        qnames=np.array([], dtype=object),
        tid=np.array([], np.int32), pos=np.array([], np.int32),
        flag=np.array([], np.uint16), rnext=np.array([], np.int32),
        nh=np.array([], np.int32), cigar_ops=np.array([], np.int8),
        cigar_lens=np.array([], np.int32),
        cigar_offsets=np.array([0], np.int64),
    )
