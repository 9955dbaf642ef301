"""Multi-host execution over DCN: the ``degnorm_mpi`` replacement.

The reference's distributed mode is a second MPI binary with rank-aware
control flow, tagged sends of coverage dictionaries, and the shared
filesystem as a broadcast channel (``__main_mpi__.py``, ``nmf_mpi.py``;
SURVEY.md §5.8).  Here the SAME single-binary pipeline becomes multi-host
by initializing ``jax.distributed`` and building one global mesh: gene
buckets are globally sharded along the gene axis, each host feeds its
addressable shard, and the per-iteration global update's column sums ride
XLA collectives (psum) — no rank-aware application code.

Launch exactly ONE process per host (or via your cluster runner); it
drives every GPU of its host (``jax.local_devices()``).  Two processes on
one host would each reserve most of every card's memory at first use, so
the second fails for want of memory:

    DEGNORM_JAX_COORDINATOR=host0:8476 DEGNORM_JAX_NUM_PROCESSES=2 \
    DEGNORM_JAX_PROCESS_ID=<i> degnorm-jax --bam-files ... --multihost

Nothing on a plain GPU host tells JAX of a cluster, so all three variables
are required for a multi-host run.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import jax

from degnorm_jax.parallel.sharded import make_mesh

log = logging.getLogger("degnorm_jax")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or DEGNORM_JAX_* env vars.

    No-op for a single-process run (no coordinator and num_processes <= 1).
    One process per host drives all of its local GPUs (see the module
    docstring); ``local_device_ids`` is left to JAX's default, every
    visible card.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "DEGNORM_JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DEGNORM_JAX_NUM_PROCESSES", "0"))
    if process_id is None:
        process_id = int(os.environ.get("DEGNORM_JAX_PROCESS_ID", "-1"))

    if not coordinator_address and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes > 0:
        kwargs["num_processes"] = num_processes
    if process_id >= 0:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    log.info("jax.distributed initialized: process %d / %d, %d local / %d "
             "global devices", jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())


def global_mesh():
    """1-D gene-parallel mesh over every device in the job (all hosts)."""
    return make_mesh(jax.devices())


def is_coordinator() -> bool:
    return jax.process_index() == 0


def broadcast_string(s: str, max_len: int = 1024) -> str:
    """Broadcast a string (e.g. the coordinator's timestamped output-dir
    name) from process 0 to all processes — the reference bcasts its
    output dir the same way (``__main_mpi__.py:62-71``).  Every process
    must call this (it is a collective)."""
    import numpy as np
    from jax.experimental import multihost_utils

    data = s.encode("utf-8")
    if len(data) > max_len:
        raise ValueError(f"string longer than {max_len} bytes")
    arr = np.zeros(max_len + 2, np.uint8)
    arr[0], arr[1] = len(data) >> 8, len(data) & 0xFF
    arr[2:2 + len(data)] = np.frombuffer(data, np.uint8)
    out = np.asarray(multihost_utils.broadcast_one_to_all(arr))
    n = (int(out[0]) << 8) | int(out[1])
    return bytes(out[2:2 + n]).decode("utf-8")


def barrier(name: str = "degnorm") -> None:
    """Block until every process reaches the same point (the reference's
    ``COMM.Barrier()``).  No-op in single-process jobs."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
