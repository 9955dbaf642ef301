"""Multi-chip traffic contract, pinned at the HLO level.

The reference's distributed loop re-ships every coverage matrix through
rank 0 on every iteration (nmf_mpi.py:740-770).  This engine's contract
is the opposite: gene shards stay device-resident for the whole run and
the ONLY cross-device traffic in an iteration is the small outer-update
reductions — (p,)-vector column sums and at most (n, p)-sized DI
gathers.  These tests compile the real iteration steps over the 8-virtual-
device mesh and assert, on the optimized HLO:

  * at least one collective exists (the test has teeth), and
  * no collective instruction carries a tensor anywhere near the
    (G, p, W) coverage class — every collective operand/result stays
    within the (n, p) outer-state class.

Per-iteration cross-device bytes are thus provably O(n*p), so
gene-data-parallel scaling has no coverage-sized communication term.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.parallel.sharded import (gene_sharding, make_mesh,
                                          shard_bucket,
                                          sharded_iteration_step)

G, p, W = 32, 4, 256


def _bucket(seed=5):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, W)
    F = (np.abs(np.sin(np.pi * t))[None, None, :]
         * (1 + rng.random((G, p, 1))) * 20).astype(np.float32)
    lengths = rng.integers(W // 2, W + 1, size=G)
    mask = np.arange(W)[None, :] < lengths[:, None]
    return np.round(F * mask[:, None, :]).astype(np.float32), mask


_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")


def _collective_lines(hlo: str):
    out = []
    for line in hlo.splitlines():
        if any(f" {op}(" in line or f" {op}-start(" in line
               for op in _COLLECTIVES):
            out.append(line.strip())
    return out


def _max_collective_elems(lines):
    """Largest tensor element count appearing in any collective line
    (operands and results both appear in the line text)."""
    worst = 0
    for line in lines:
        for m in re.finditer(r"\w+\[([\d,]*)\]", line):
            dims = m.group(1)
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            worst = max(worst, n)
    return worst


def _assert_contract(hlo: str, limit_elems: int, needs_collective=True):
    lines = _collective_lines(hlo)
    if needs_collective:
        assert lines, "expected at least one collective in the HLO"
    worst = _max_collective_elems(lines)
    assert worst <= limit_elems, (
        f"collective carries {worst} elements (limit {limit_elems}):\n"
        + "\n".join(l[:160] for l in lines))
    # the coverage bucket itself must never ride a collective
    for line in lines:
        assert f"[{G},{p},{W}]" not in line and f"[{G * p},{W}]" not in line


def test_sharded_iteration_step_traffic_gspmd():
    """GSPMD lowering of the fused sharded step: only outer-state-sized
    collectives (the reference inefficiency being proven-fixed:
    nmf_mpi.py:740-770 re-ships (G, p, W) per iteration)."""
    mesh = make_mesh()
    F, mask = _bucket()
    F_s, m_s = shard_bucket(F, mask, mesh)
    xw = jax.device_put(np.abs(np.random.default_rng(0).standard_normal(
        (G, p))).astype(np.float32) * 100, gene_sharding(mesh, 2))
    ds = jax.device_put(np.zeros(G, np.int32), gene_sharding(mesh, 1))
    scale = jnp.ones((p,), jnp.float32)
    cfg = NMFConfig(nmf_iter=4)
    hlo = sharded_iteration_step.lower(
        F_s, m_s, xw, scale, ds, cfg.kernel_key(),
        EngineConfig(use_pallas=False), None, "genes").compile().as_text()
    # outer-state class: (G, p) DI gathers at most
    _assert_contract(hlo, limit_elems=G * p)


def test_sharded_iteration_step_traffic_shard_map():
    """shard_map + the GPU kernel (interpreted here): same contract (the
    kernel is per-gene; only the outer update communicates)."""
    mesh = make_mesh()
    F, mask = _bucket()
    F_s, m_s = shard_bucket(F, mask, mesh)
    xw = jax.device_put(np.abs(np.random.default_rng(0).standard_normal(
        (G, p))).astype(np.float32) * 100, gene_sharding(mesh, 2))
    ds = jax.device_put(np.zeros(G, np.int32), gene_sharding(mesh, 1))
    scale = jnp.ones((p,), jnp.float32)
    cfg = NMFConfig(nmf_iter=4)
    hlo = sharded_iteration_step.lower(
        F_s, m_s, xw, scale, ds, cfg.kernel_key(),
        EngineConfig(use_pallas=True, pallas_interpret=True),
        mesh, "genes").compile().as_text()
    _assert_contract(hlo, limit_elems=G * p)


@pytest.mark.parametrize("df", [True, False])
def test_engine_device_update_traffic(df):
    """The engine device loop's per-iteration global update
    (_device_iteration_update / _df) on gene-sharded bucket outputs:
    every collective stays in the (n, p) outer-state class — including
    the double-float path's compensated tree reductions."""
    from degnorm_jax.core import dfloat as dfm
    from degnorm_jax.engine import (_device_iteration_update,
                                    _device_iteration_update_df)
    mesh = make_mesh()
    n = G
    rng = np.random.default_rng(1)
    rho_part = jax.device_put(
        (rng.random((G, p)) * 0.8).astype(np.float32),
        gene_sharding(mesh, 2))
    idx_part = jax.device_put(np.arange(G, dtype=np.int32),
                              gene_sharding(mesh, 1))
    repl = NamedSharding(mesh, P())
    xw64 = rng.random((n, p)) * 100 + 1
    sc64 = rng.random(p) + 0.5
    if df:
        xw = dfm.DF(*(jax.device_put(jnp.asarray(a), repl)
                      for a in dfm.from_f64_np(xw64)))
        sc = dfm.DF(*(jax.device_put(jnp.asarray(a), repl)
                      for a in dfm.from_f64_np(sc64)))
        lowered = _device_iteration_update_df.lower(
            (rho_part,), (idx_part,), xw, sc, n)
    else:
        xw = jax.device_put(jnp.asarray(xw64, jnp.float32), repl)
        sc = jax.device_put(jnp.asarray(sc64, jnp.float32), repl)
        lowered = _device_iteration_update.lower(
            (rho_part,), (idx_part,), xw, sc, n)
    hlo = lowered.compile().as_text()
    # scatter target is (n+1, p); allow the padded row plus slack for
    # tree-reduction intermediates, but nothing bucket-sized
    _assert_contract(hlo, limit_elems=(n + 1) * p, needs_collective=False)
    # sanity: SOME cross-device op exists on an 8-device mesh unless XLA
    # chose full replication of the small arrays — either way the
    # contract holds; record the count for debugging
    assert "[%s,%s,%s]" % (G, p, W) not in hlo


def test_seqpar_column_sharded_step_traffic():
    """SEQUENCE-PARALLEL (column-sharded) contract, promoted from
    tools/seqpar_collectives.py (round-4 verdict item 6): on a bucket
    whose POSITION axis is sharded over the mesh (the outlier-length
    gene path, EngineConfig.seqpar_width), GSPMD may emit all-reduces
    only at W-reduction sites — the largest legal payload is the rank-1
    Gram (Gs, p, p) — and must never replicate the sharded (Gs, p, Ws)
    coverage buffer (no full-width tensor may appear ANYWHERE in the
    optimized module, let alone ride a collective)."""
    from degnorm_jax.engine import _bucket_step
    from degnorm_jax.parallel.seqpar import shard_columns

    Gs, Ws = 8, 2048
    mesh = make_mesh()
    rng = np.random.default_rng(3)
    t = np.linspace(0, 1, Ws)
    F = (np.abs(np.sin(np.pi * t))[None, None, :]
         * (1 + rng.random((Gs, p, 1))) * 20).astype(np.float32)
    lengths = rng.integers(Ws // 2, Ws + 1, size=Gs)
    mask = np.arange(Ws)[None, :] < lengths[:, None]
    F = np.round(F * mask[:, None, :]).astype(np.float32)

    F_s = shard_columns(np.asarray(F), mesh)
    m_s = shard_columns(np.asarray(mask), mesh)
    scale = np.ones((p,), np.float32)
    ds = np.zeros((Gs,), np.int32)
    cfg = NMFConfig(nmf_iter=4)
    hlo = _bucket_step.lower(
        F_s, m_s, scale, ds, cfg.kernel_key(), EngineConfig(),
        True, None, "genes", True).compile().as_text()

    lines = _collective_lines(hlo)
    assert lines, "expected collectives on the column-sharded step"
    # ONE documented exception: XLA lowers the sharded hi-cov rank cumsum
    # (bin setup, once per step — not in the nmf_iter loop) by gathering
    # the s32[Gs, Ws] index map: 1/p of the bucket's elements, integer,
    # never the f32 coverage.  Everything else must stay in the
    # W-reduction class (the rank-1 Gram, (Gs, p, p), is the largest).
    cumsum_gathers = [l for l in lines
                     if "all-gather" in l and "cumsum" in l
                     and re.search(rf"s\d+\[{Gs},{Ws}\]", l)]
    assert len(cumsum_gathers) <= 1, "\n".join(cumsum_gathers)
    rest = [l for l in lines if l not in cumsum_gathers]
    worst = _max_collective_elems(rest)
    assert worst <= Gs * p * p, (
        f"collective carries {worst} elements (Gram bound {Gs * p * p}):\n"
        + "\n".join(l[:160] for l in rest))
    # the sharded f32 coverage buffer must never materialize full-width
    for pat in (f"f32[{Gs},{p},{Ws}]", f"f32[{Gs * p},{Ws}]"):
        assert pat not in hlo, f"full-width buffer {pat} in module"
