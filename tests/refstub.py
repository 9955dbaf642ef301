"""Functional stand-ins that let the REFERENCE package run end-to-end in
this environment (pysam/HTSeq/samtools are not installable here; the
reference code itself is imported read-only from /root/reference).

Unlike the minimal monkeypatch in test_coverage_parity.py (which bypasses
``load_chromosome_reads`` entirely), the ``pysam.AlignmentFile`` here is
FUNCTIONAL: it decodes real BAM bytes through our own from-scratch reader
(degnorm_jax.io.bam) and exposes the exact attribute surface the reference
uses (reference ``loaders.py:64-70``, ``reads.py:140-262``):

    AlignmentFile(path, mode='rb', index_filename=...)
      .header.as_dict()['SQ'] -> [{'SN': name, 'LN': length}, ...]
      .fetch(chrom)           -> iterable of reads with .query_name, .pos,
                                 .cigarstring, .rnext, .has_tag/.get_tag('NH')
      .close()

This is what makes the all-up twin run (tests/test_twin_run.py) possible:
the reference's complete ``__main__.main()`` executes unmodified on the
same BAM files our CLI reads.
"""
import os
import sys
import types

import numpy as np


# --------------------------------------------------------------------------
# HTSeq: per-base GenomicArrayOfSets, just enough for the reference's
# get_gene_overlap_structure (gene_processing.py:167-194).
# --------------------------------------------------------------------------
class StubInterval:
    def __init__(self, chrom, start, end, strand="."):
        self.chrom, self.start, self.end = chrom, start, end


class StubGAS:
    def __init__(self, chroms, stranded=False):
        self.base = {}

    class _View:
        def __init__(self, gas, iv):
            self.gas, self.iv = gas, iv

        def __iadd__(self, value):
            for p in range(self.iv.start, self.iv.end):
                self.gas.base.setdefault(p, set()).add(value)
            return self

        def steps(self):
            run_set, run_start = None, None
            for p in range(self.iv.start, self.iv.end + 1):
                s = frozenset(self.gas.base.get(p, set()))
                if p == self.iv.end or s != run_set:
                    if run_set is not None:
                        yield ((run_start, p), set(run_set))
                    run_set, run_start = s, p

    def __getitem__(self, iv):
        return self._View(self, iv)

    def __setitem__(self, iv, view):
        pass   # supports the `gas[iv] += x` statement form


# --------------------------------------------------------------------------
# pysam: functional AlignmentFile over degnorm_jax.io.bam.
# --------------------------------------------------------------------------
class _StubRead:
    __slots__ = ("query_name", "pos", "cigarstring", "rnext", "_nh")

    def __init__(self, qname, pos, cigar, rnext, nh):
        self.query_name = qname
        self.pos = pos
        self.cigarstring = cigar
        self.rnext = rnext
        self._nh = nh

    def has_tag(self, tag):
        return tag == "NH" and self._nh > 0

    def get_tag(self, tag):
        if not self.has_tag(tag):
            raise KeyError(f"tag {tag!r} not present")
        return self._nh


class _StubHeader:
    def __init__(self, bam_header):
        self._h = bam_header

    def as_dict(self):
        return {"SQ": [{"SN": n, "LN": int(l)}
                       for n, l in zip(self._h.ref_names,
                                       self._h.ref_lengths)]}


_BAM_CACHE = {}


class StubAlignmentFile:
    """pysam.AlignmentFile replacement backed by our own BAM decoder."""

    def __init__(self, filename, mode="rb", index_filename=None, **kw):
        key = (os.path.abspath(filename), os.path.getmtime(filename))
        if key not in _BAM_CACHE:
            _BAM_CACHE.clear()   # keep at most one decoded file resident
            from degnorm_jax.io import bam as bamio
            _BAM_CACHE[key] = bamio.read_bam(filename)
        self._hdr, self._cols = _BAM_CACHE[key]
        self.header = _StubHeader(self._hdr)

    def fetch(self, chrom=None):
        if chrom is not None and chrom not in self._hdr.ref_names:
            raise ValueError(f"invalid contig {chrom!r}")   # pysam behavior
        tid = None if chrom is None else self._hdr.ref_names.index(chrom)
        cols = self._cols
        idx = (np.arange(len(cols)) if tid is None
               else np.nonzero(cols.tid == tid)[0])
        for i in idx:
            yield _StubRead(str(cols.qnames[i]), int(cols.pos[i]),
                            cols.cigar_string(i), int(cols.rnext[i]),
                            int(cols.nh[i]))

    def close(self):
        pass


def install():
    """Install the stub modules so ``import degnorm.<anything>`` works.

    Idempotent; safe to call from several test modules.  pkg_resources'
    resource_filename is pointed at the real (read-only) reference package
    so the ASCII banner and the report HTML template load for real.
    """
    # Mutate any pre-existing stub modules IN PLACE: the reference package
    # binds `import pysam` into its module namespaces at first import, so
    # replacing the sys.modules entry would not upgrade an already-imported
    # degnorm.loaders (test modules run in arbitrary order).
    pr = sys.modules.get("pkg_resources")
    if pr is None:
        pr = types.ModuleType("pkg_resources")
        sys.modules["pkg_resources"] = pr
    pr.resource_filename = (
        lambda pkg, path: os.path.join("/root/reference/degnorm", path))
    pr.get_distribution = lambda pkg: types.SimpleNamespace(version="0.1.4")
    pr._degnorm_refstub = True
    ps = sys.modules.get("pysam")
    if ps is None:
        ps = types.ModuleType("pysam")
        sys.modules["pysam"] = ps
    ps._degnorm_refstub = True
    ps.AlignmentFile = StubAlignmentFile
    if "HTSeq" not in sys.modules:
        ht = types.ModuleType("HTSeq")
        ht.GenomicArrayOfSets = StubGAS
        ht.GenomicInterval = StubInterval
        sys.modules["HTSeq"] = ht
    import pandas as pd
    try:
        # pandas>=3 infers Arrow-backed string arrays whose .values have no
        # .sort(); the reference code predates that (visualizations.py:236)
        pd.set_option("future.infer_string", False)
    except Exception:
        pass
    import networkx as nx
    if not hasattr(nx, "from_numpy_matrix"):
        nx.from_numpy_matrix = nx.from_numpy_array   # networkx>=3 rename
    if not hasattr(np, "float_"):
        np.float_ = np.float64   # numpy>=2 removal (reference uses np.float_)
    if "/root/reference" not in sys.path:
        sys.path.append("/root/reference")
    _shim_load_di_scores()


def pin_paired_tiebreak():
    """Pin the reference's paired mate-role tie-break to FILE ORDER.

    ``load_chromosome_reads`` sorts reads by ``qname_unpaired`` with
    pandas' default UNSTABLE quicksort (reads.py:259-261); mates share
    the key, so which mate lands first — and therefore which one anchors
    the pair (reads.py:517-520) and which gets clip-disjointified
    (reads.py:450-470) — is a numpy-sort-internals artifact.  Measured on
    a 1,709-pair fixture: 858 pairs (50%) flip vs file order, moving
    per-gene counts by up to 84 on a short gene — i.e. the reference
    DISAGREES WITH ITSELF across numpy versions by that much.  Our
    kernel's stable pair ordering (file order) is one deterministic
    choice of the same semantics; with the reference's tie-break pinned
    to the same choice, the per-(sample, chrom) artifacts are
    BYTE-IDENTICAL (tests/test_twin_run.py::test_twin_paired_end,
    PARITY.md §known deviations)."""
    import degnorm.reads as rr
    if getattr(rr.BamReadsProcessor, "_dn_tiebreak_pinned", False):
        return
    orig = rr.BamReadsProcessor.load_chromosome_reads

    def load(self, chrom):
        df = orig(self, chrom)
        if self.paired:
            df = df.sort_index().sort_values("qname_unpaired",
                                             kind="stable")
        return df

    rr.BamReadsProcessor.load_chromosome_reads = load
    rr.BamReadsProcessor._dn_tiebreak_pinned = True


def _shim_load_di_scores():
    """pandas>=3 copy-on-write makes ``Index.values`` read-only, so the
    reference's in-place ``genes.sort()`` (visualizations.py:236) raises.
    Replace load_di_scores with a behavior-identical copy whose only change
    is sorting a COPY of the index — an environment-compat shim, not a
    semantic patch (the function just orders rows of the already-written
    degradation_index_scores.csv)."""
    try:
        import degnorm.visualizations as vz
    except Exception:
        return
    import pandas as pd

    def load_di_scores(data_dir, drop_chroms=True, order=False):
        di_file = "degradation_index_scores.csv"
        vz.check_for_files(data_dir, file_names=di_file)
        rho_df = pd.read_csv(os.path.join(data_dir, di_file),
                             index_col="gene", low_memory=False)
        genes = np.sort(np.asarray(rho_df.index.values))   # the one change
        rho_df = rho_df.loc[genes]
        sample_ids = rho_df.columns.tolist()[1:]
        ordered = rho_df[sample_ids].mean(axis=0).sort_values()
        output_cols = ordered.index.tolist() if order else sample_ids
        if drop_chroms:
            rho_df.drop("chr", axis=1, inplace=True)
        else:
            output_cols = ["chr"] + output_cols
        return rho_df[output_cols]

    vz.load_di_scores = load_di_scores
    # star-importers that already bound the old function
    for modname in ("degnorm.data_access", "degnorm.report"):
        m = sys.modules.get(modname)
        if m is not None and hasattr(m, "load_di_scores"):
            m.load_di_scores = load_di_scores
