"""Gene-data-parallel execution over a JAX device mesh.

Replaces the reference's MPI layer (``nmf_mpi.py`` + ``__main_mpi__.py``)
with the design from SURVEY.md §2.4/§5.8:

* Genes are the data-parallel axis.  Each bucket's (G, p, W) arrays are
  sharded along G with a ``NamedSharding`` over a 1-D ``Mesh``; the
  baseline-selection kernel is embarrassingly parallel over genes, so the
  per-iteration device work needs NO collectives at all.
* The cross-gene reductions of the outer loop (column sums of the adjusted
  counts, the "sample-average DI" correction) are expressed as plain
  ``jnp.sum(..., axis=0)`` over gene-sharded arrays inside ``jit`` — XLA
  lowers them to ``psum`` over the device links automatically.  Only (p,)-sized vectors
  ever cross devices.
* This removes the reference's biggest distributed inefficiency: rank 0
  re-shipping every coverage matrix to every worker on every iteration
  (nmf_mpi.py:740-770).  Here each device keeps its gene shard resident for
  the whole run and receives just the scale-factor vector.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.core.baseline import baseline_select_bucket


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis: str = "genes") -> Mesh:
    """1-D gene-data-parallel mesh over all (or the given) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def gene_sharding(mesh: Mesh, ndim: int, axis: str = "genes") -> NamedSharding:
    """Shard dim 0 (genes) and replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_bucket(F: np.ndarray, len_mask: np.ndarray, mesh: Mesh,
                 axis: str = "genes") -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Place a padded bucket on the mesh, genes split across devices.

    Uses make_array_from_callback so it works when the mesh spans multiple
    processes (each process materializes only its addressable shards; the
    host arrays are present on every process — ETL is replicated)."""
    def put(arr, ndim):
        sh = gene_sharding(mesh, ndim, axis)
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])
    return put(F, 3), put(len_mask, 2)


@functools.partial(jax.jit, static_argnames=("nmf_cfg", "eng_cfg", "mesh",
                                              "axis"))
def sharded_iteration_step(
    F: jnp.ndarray,           # (G, p, W)  gene-sharded
    len_mask: jnp.ndarray,    # (G, W)     gene-sharded
    x_weighted: jnp.ndarray,  # (G, p)     gene-sharded (row-aligned with F)
    scale_factors: jnp.ndarray,  # (p,)    replicated
    ds_start: jnp.ndarray,    # (G,)       gene-sharded
    nmf_cfg: NMFConfig,
    eng_cfg: EngineConfig,
    mesh: Optional[Mesh] = None,
    axis: str = "genes",
):
    """One complete DegNorm iteration for a single gene-sharded bucket —
    device bucket work AND the global factor update fused under one jit.

    This is the multi-chip train-step analog: per-gene NMF/trimming is
    local to each device's shard; the only cross-device traffic is the
    psum hidden inside the axis-0 column sums (three (p,)-vectors).

    Pass ``mesh`` to run the per-gene kernel portion under shard_map —
    required for the Pallas kernels on a multi-device mesh (GSPMD cannot
    partition an opaque custom call; shard_map hands it local shapes).
    Without it the kernel lowers through GSPMD (pure-XLA path only).

    Replicates reference nmf.py:560-596 / core.degnorm.iteration_update.
    Returns (rho, x_adj, x_weighted', norm_factors, scale_factors', ran_bs).
    """
    def kernel(F, len_mask, ds_start, scale_factors):
        F_adj = F.astype(scale_factors.dtype) / scale_factors[None, :, None]
        return baseline_select_bucket(F_adj, len_mask, nmf_cfg, eng_cfg,
                                      ds_start=ds_start)

    if mesh is not None and mesh.devices.size > 1:
        from degnorm_jax.engine import _shard_map_genes
        res = _shard_map_genes(kernel, mesh, axis,
                               (F, len_mask, ds_start), (scale_factors,))
    else:
        res = kernel(F, len_mask, ds_start, scale_factors)

    # clip / correct_di_scores / norm-factor fold-in (nmf.py:396-399,
    # 574-590); cross-gene column sums become implicit psums over the
    # gene shards.  Single shared implementation: core/degnorm.py.
    from degnorm_jax.core.degnorm import device_iteration_math
    rho, x_adj, x_weighted_new, norm_factors, scale_new = \
        device_iteration_math(res.rho, x_weighted, scale_factors)
    return rho, x_adj, x_weighted_new, norm_factors, scale_new, res.ran_bs
