"""End-to-end DegNormEngine parity vs the golden oracle and the reference."""
import numpy as np
import pytest
from collections import OrderedDict

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.engine import DegNormEngine
from degnorm_jax.oracle import nmfoa as oracle
from tests.conftest import random_coverage


def make_dataset(seed=21, n=12, p=3):
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(120 + rng.integers(0, 500))
        cov[f"gene{i}"] = random_coverage(
            rng, p, L, scale=3 + 6 * rng.random(), degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


@pytest.mark.parametrize("method", ["eigh", "power"])
def test_engine_matches_oracle_f64(method):
    cov, X = make_dataset()
    cfg = NMFConfig(nmf_iter=8, degnorm_iter=3)
    eng = EngineConfig(rank1_method=method, dtype="float64",
                       power_iters_cold=200, power_iters_warm=60,
                       bucket_widths=(256, 512, 1024))
    res = DegNormEngine(cfg, eng).run(cov, X)
    gold = oracle.degnorm_fit(list(cov.values()), X, cfg)

    np.testing.assert_allclose(res.rho, gold.rho, rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(res.x_adj, gold.x_adj, rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(res.scale_factors, gold.scale_factors,
                               rtol=3e-4)
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  gold.ran_baseline_selection)
    ests = res.estimates()
    for e_j, e_o in zip(ests, gold.estimates):
        np.testing.assert_allclose(e_j, e_o, rtol=2e-3, atol=1e-3)


def test_engine_f32_tolerance():
    """The production float32 path stays within loose tolerance of the
    float64 oracle — the gate for device numerics."""
    cov, X = make_dataset(seed=5)
    cfg = NMFConfig(nmf_iter=8, degnorm_iter=3)
    eng = EngineConfig(rank1_method="power", dtype="float32",
                       bucket_widths=(256, 512, 1024))
    res = DegNormEngine(cfg, eng).run(cov, X)
    gold = oracle.degnorm_fit(list(cov.values()), X, cfg)
    np.testing.assert_allclose(res.rho, gold.rho, rtol=0, atol=5e-3)
    np.testing.assert_allclose(
        res.x_adj / gold.x_adj, 1.0, rtol=0, atol=5e-3)


def test_engine_input_validation():
    cov, X = make_dataset(n=4)
    eng = DegNormEngine(NMFConfig(nmf_iter=2, degnorm_iter=1))
    with pytest.raises(ValueError):
        eng.run(cov, X[:2])
    with pytest.raises(ValueError):
        DegNormEngine(NMFConfig(downsample_rate=10**6)).run(cov, X)


def test_engine_multi_chunk_buckets():
    """Buckets above max_genes_per_batch split into multiple device
    batches; results must match the unchunked run exactly."""
    cov, X = make_dataset(seed=33, n=13)
    cfg = NMFConfig(nmf_iter=5, degnorm_iter=2)
    base = dict(rank1_method="power", dtype="float64",
                bucket_widths=(1024,))
    r1 = DegNormEngine(cfg, EngineConfig(**base)).run(cov, X)
    r2 = DegNormEngine(cfg, EngineConfig(
        **base, max_genes_per_batch=4)).run(cov, X)
    np.testing.assert_allclose(r2.rho, r1.rho, rtol=1e-12)
    np.testing.assert_allclose(r2.x_adj, r1.x_adj, rtol=1e-12)
    for a, b in zip(r2.estimates(), r1.estimates()):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_run_raises_kernel_error_without_retry(monkeypatch):
    """A kernel that fails fails the fit: run() calls _run() once, does not
    retry and does not switch the device path."""
    cov, X = make_dataset(seed=9, n=6)
    cfg = NMFConfig(nmf_iter=3, degnorm_iter=1)
    eng_cfg = EngineConfig(bucket_widths=(1024,), pallas_interpret=True)
    engine = DegNormEngine(cfg, eng_cfg)
    calls = []

    def failing_run(self, *a, **k):
        calls.append(self.eng_cfg)
        raise RuntimeError("Triton compilation failed: out of resources")

    monkeypatch.setattr(DegNormEngine, "_run", failing_run)
    with pytest.raises(RuntimeError, match="Triton compilation failed"):
        engine.run(cov, X)
    assert calls == [eng_cfg]
    assert engine.eng_cfg is eng_cfg


@pytest.mark.parametrize("env", [None, "custom"])
def test_default_cache_dir(env, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache lives
    at <checkout>/.jax_cache, a fixed path listed in .gitignore."""
    import os
    from degnorm_jax import engine as engine_mod
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            engine_mod.__file__)))
        assert engine_mod.default_cache_dir() == os.path.join(root,
                                                              ".jax_cache")
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        target = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
        assert engine_mod.default_cache_dir() == target


def test_refit_reuses_device_buckets():
    """run(reuse_device_data=True) must skip pack+upload and reproduce the
    fresh-engine fit exactly (results are invariant to the persisted
    presort permutation; the device buckets carry the same data)."""
    cov, X = make_dataset(seed=31, n=20, p=4)
    cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)
    eng_cfg = EngineConfig(rank1_method="power", dtype="float32",
                           bucket_widths=(256, 512, 1024))
    engine = DegNormEngine(cfg, eng_cfg)
    first = engine.run(cov, X)
    refit = engine.run(cov, X, reuse_device_data=True)
    # no repack/upload happened (encode_upload only exists after _pack;
    # buffer identity may still change — the refit's init presort is
    # free to re-permute the persisted exit-round order, which is
    # result-invariant)
    assert "encode_upload" not in engine.timings
    assert engine.timings["pack"] < 0.05
    np.testing.assert_allclose(refit.rho, first.rho, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(refit.x_adj, first.x_adj, rtol=1e-6)
    np.testing.assert_array_equal(refit.ran_baseline_selection,
                                  first.ran_baseline_selection)

    # a fresh engine (no reuse) agrees too — the refit didn't corrupt
    control = DegNormEngine(cfg, eng_cfg).run(cov, X)
    np.testing.assert_allclose(refit.rho, control.rho, rtol=1e-6, atol=1e-7)
