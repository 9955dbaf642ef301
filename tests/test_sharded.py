"""Multi-device gene sharding on the 8-device virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.core.baseline import baseline_select_bucket
from degnorm_jax.parallel.sharded import (
    make_mesh, shard_bucket, gene_sharding, sharded_iteration_step)
from tests.conftest import random_coverage
from tests.test_core_parity import make_bucket


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_bucket_matches_single_device():
    """The bucket kernel is gene-parallel: sharding the G axis across 8
    devices must be bit-identical to single-device execution."""
    rng = np.random.default_rng(31)
    mats = [random_coverage(rng, 3, int(100 + rng.integers(0, 150)),
                            degraded=(i % 2 == 0)) for i in range(16)]
    F, mask = make_bucket(mats, 256)
    cfg = NMFConfig(nmf_iter=6)
    eng = EngineConfig(rank1_method="power", dtype="float64")

    res_single = baseline_select_bucket(F, mask, cfg, eng)

    mesh = make_mesh()
    F_s, mask_s = shard_bucket(np.asarray(F), np.asarray(mask), mesh)
    res_shard = baseline_select_bucket(F_s, mask_s, cfg, eng)

    np.testing.assert_array_equal(np.asarray(res_single.rho),
                                  np.asarray(res_shard.rho))
    np.testing.assert_array_equal(np.asarray(res_single.est_E),
                                  np.asarray(res_shard.est_E))


def test_sharded_iteration_step_runs_and_matches_host_update():
    """Fused sharded iteration (bucket kernel + global update with implicit
    psum) equals the host-side reference update path."""
    from degnorm_jax.core import degnorm as outer

    rng = np.random.default_rng(32)
    n, p = 16, 4
    mats = [random_coverage(rng, p, int(150 + rng.integers(0, 100)),
                            degraded=True) for i in range(n)]
    F, mask = make_bucket(mats, 256)
    X = np.round(np.abs(rng.standard_normal((n, p))) * 200 + 20)

    cfg = NMFConfig(nmf_iter=6, degnorm_iter=1)
    eng = EngineConfig(rank1_method="power", dtype="float64")

    scale0 = np.abs(rng.standard_normal(p)) + 0.5
    x_weighted = X / scale0

    mesh = make_mesh()
    F_s, mask_s = shard_bucket(np.asarray(F), np.asarray(mask), mesh)
    xw_s = jax.device_put(x_weighted, gene_sharding(mesh, 2))
    ds = jnp.zeros(n, jnp.int32)

    rho, x_adj, xw_new, norm, scale_new, ran_bs = sharded_iteration_step(
        F_s, mask_s, xw_s, jnp.asarray(scale0), ds, cfg, eng)

    # host-side equivalent
    res = baseline_select_bucket(
        jnp.asarray(F) / jnp.asarray(scale0)[None, :, None],
        jnp.asarray(mask), cfg, eng)
    st = outer.GlobalState(
        x=X.astype(float), x_weighted=x_weighted,
        x_adj=x_weighted.copy(),
        rho=np.zeros((n, p)), norm_factors=np.ones(p),
        scale_factors=scale0)
    st2 = outer.iteration_update(st, np.asarray(res.rho))

    np.testing.assert_allclose(np.asarray(rho), st2.rho, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(x_adj), st2.x_adj, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(scale_new),
                               scale0 * st2.norm_factors, rtol=1e-12)


def test_shard_map_pallas_matches_gspmd_xla():
    """The GPU kernel on a multi-device mesh runs under shard_map with
    LOCAL shard shapes (GSPMD cannot partition an opaque custom call) —
    the interpreted-kernel shard_map path must match the GSPMD XLA
    lowering.  W=2048 at p=4 is inside the kernel's gate."""
    from degnorm_jax.ops.nmf_gpu import kernel_supported
    assert kernel_supported((2, 4, 2048), jnp.float32)
    from tests.conftest import random_coverage
    from tests.test_core_parity import make_bucket

    rng = np.random.default_rng(5)
    mats = [np.round(random_coverage(rng, 4, int(rng.integers(1100, 2049)),
                                     degraded=(i % 2 == 0))
                     ).astype(np.float32) for i in range(16)]
    F, mask = make_bucket(mats, 2048, dtype=np.float32)
    mesh = make_mesh()
    F_s, mask_s = shard_bucket(np.asarray(F), np.asarray(mask), mesh)
    xw = jnp.asarray(np.abs(rng.standard_normal((16, 4))) * 100 + 10,
                     jnp.float32)
    sf = jnp.ones(4, jnp.float32)
    ds = jnp.zeros(16, jnp.int32)
    cfg = NMFConfig(nmf_iter=4)
    out_ref = sharded_iteration_step(
        jnp.asarray(F), jnp.asarray(mask), xw, sf, ds, cfg,
        EngineConfig(use_pallas=False))
    out_sm = sharded_iteration_step(
        F_s, mask_s, xw, sf, ds, cfg,
        EngineConfig(use_pallas=True, pallas_interpret=True), mesh=mesh)
    for a, b in zip(out_ref, out_sm):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=5e-3, atol=5e-4)
