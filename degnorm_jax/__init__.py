"""degnorm-jax: an RNA-seq degradation-normalization (DegNorm) engine on JAX.

A from-scratch JAX/XLA/Pallas re-design of the DegNorm pipeline
(NUStatBioinfo/DegNorm): BAM/GTF ETL feeds per-gene coverage matrices that are
packed into padded length buckets and run through a batched, masked
NMF-over-approximation kernel on the GPU, with gene-data-parallel sharding across
device meshes replacing the reference's MPI layer.
"""

__version__ = "0.1.0"

from degnorm_jax.config import NMFConfig, EngineConfig, PipelineConfig  # noqa: F401


def run_pipeline(*args, **kwargs):
    """Convenience re-export of pipeline.run.run_pipeline (lazy import so
    that `import degnorm_jax` stays light)."""
    from degnorm_jax.pipeline.run import run_pipeline as _rp
    return _rp(*args, **kwargs)


def DegNormEngine(*args, **kwargs):
    """Convenience constructor re-export (lazy import)."""
    from degnorm_jax.engine import DegNormEngine as _E
    return _E(*args, **kwargs)
