"""The Pallas GPU NMF kernel (ops/nmf_gpu.py) against the XLA loop.

The kernel runs here in the Pallas interpreter; the same code compiled for
the card is checked by chip_smoke.py.  Shapes stay small (G <= 16,
nmf_iter <= 10) because the interpreter executes the per-gene programs one
after another.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.core.baseline import baseline_select_bucket
from degnorm_jax.core.nmf import nmf_masked
from degnorm_jax.ops import nmf_gpu
from degnorm_jax.ops.nmf_gpu import (kernel_enabled, kernel_supported,
                                     nmf_masked_gpu)
from tests.conftest import random_coverage
from tests.test_core_parity import make_bucket

KW = dict(nmf_iter=10, power_iters_cold=60, power_iters_warm=12)


def _bucket(seed, p, W, lengths):
    rng = np.random.default_rng(seed)
    mats = [random_coverage(rng, p, L, degraded=(i % 2 == 0)
                            ).astype(np.float32)
            for i, L in enumerate(lengths)]
    return make_bucket(mats, W, dtype=np.float32)


def _close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=rtol, atol=atol)


def test_pallas_nmf_matches_xla():
    F, mask = _bucket(44, 4, 256, (150, 256, 90))
    K1, E1, u1 = nmf_masked(F, mask, **KW)
    K2, E2, u2 = nmf_masked_gpu(F, mask, interpret=True, **KW)
    _close(K1, K2)
    _close(E1, E2)
    _close(u1, u2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("W", [256, 1024])
@pytest.mark.parametrize("p", [2, 3, 8, 9, 16, 32])
def test_kernel_matches_xla_shapes(p, W):
    """Every padded sample count (p not a power of two pads with zero
    rows) and two widths (one and several Gram chunks per sweep)."""
    F, mask = _bucket(100 + p, p, W, (W, W // 2 + 7, W // 3))
    K1, E1, _ = nmf_masked(F, mask, **KW)
    K2, E2, _ = nmf_masked_gpu(F, mask, interpret=True, **KW)
    _close(K1, K2)
    _close(E1, E2)


def test_kernel_u0_resume():
    """A warm start u0 (the trim loop's resumed rank-1) with a reduced cold
    count follows the XLA loop from the same start."""
    F, mask = _bucket(61, 5, 256, (200, 256, 120, 180))
    _, _, u_prev = nmf_masked(F, mask, **KW)
    kw = dict(KW, power_iters_cold=8)
    K1, E1, u1 = nmf_masked(F, mask, u0=u_prev, **kw)
    K2, E2, u2 = nmf_masked_gpu(F, mask, u0=u_prev, interpret=True, **kw)
    _close(K1, K2)
    _close(E1, E2)
    _close(u1, u2, rtol=1e-5, atol=1e-6)


def test_kernel_gene_active_zeroes_outputs():
    """Inactive genes return at once with zero K, E and u; active genes are
    untouched by their neighbours' skipping."""
    F, mask = _bucket(62, 4, 256, (200, 256, 120, 180, 90))
    active = jnp.asarray([True, False, True, False, True])
    K1, E1, u1 = nmf_masked(F, mask, **KW)
    K2, E2, u2 = nmf_masked_gpu(F, mask, gene_active=active, interpret=True,
                                **KW)
    on = np.asarray(active)
    for full, part in ((K1, K2), (E1, E2), (u1, u2)):
        part = np.asarray(part)
        assert not part[~on].any()
        _close(np.asarray(full)[on], part[on])


@pytest.mark.parametrize("p", [3, 9])
def test_kernel_padded_rows_exact(p):
    """Zero rows padding p up to a power of two come out exactly zero and
    leave the real rows exactly as an explicitly padded input gives them."""
    F, mask = _bucket(63 + p, p, 256, (256, 200, 130))
    P = nmf_gpu.next_pow2(p)
    K, E, u = nmf_masked_gpu(F, mask, interpret=True, **KW)
    Fp = jnp.pad(F, ((0, 0), (0, P - p), (0, 0)))
    u0 = jnp.pad(jnp.full((3, p), 1 / np.sqrt(np.float32(p)), jnp.float32),
                 ((0, 0), (0, P - p)))
    Kp, Ep, up = nmf_masked_gpu(Fp, mask, u0=u0, interpret=True, **KW)
    assert K.shape == (3, p) and u.shape == (3, p)
    assert not np.asarray(Kp)[:, p:].any()
    assert not np.asarray(up)[:, p:].any()
    np.testing.assert_array_equal(np.asarray(Kp)[:, :p], np.asarray(K))
    np.testing.assert_array_equal(np.asarray(Ep), np.asarray(E))


@pytest.mark.parametrize("shape,dtype,kw,admitted", [
    ((64, 8, 1024), jnp.float32, {}, True),
    ((64, 8, 4096), jnp.float32, {}, True),
    ((64, 16, 2048), jnp.float32, {}, True),
    ((64, 9, 256), jnp.float32, {}, True),
    ((64, 8, 8192), jnp.float32, {}, False),         # state past MAX_STATE
    ((64, 32, 1024), jnp.float32, {}, False),        # P past MAX_SAMPLES
    ((4, 8, 70000), jnp.float32, {}, False),         # exact-width outlier
    ((64, 8, 1024), jnp.float64, {}, False),
    ((64, 8, 1024), jnp.float32, {"nmf_tol": 1e-4}, False),
    ((64, 8, 1024), jnp.float32, {"method": "eigh"}, False),
], ids=["p8w1k", "p8w4k", "p16w2k", "p9w256", "p8w8k", "p32", "outlier",
        "f64", "nmf_tol", "eigh"])
def test_kernel_gate(shape, dtype, kw, admitted):
    assert kernel_supported(shape, dtype, **kw) is admitted


@pytest.mark.parametrize("use_pallas,interpret,enabled", [
    (True, False, False),      # CPU: the XLA loop
    (True, True, True),        # CPU test mode: the interpreter
    (False, True, False),      # switched off
])
def test_kernel_enabled_on_cpu(use_pallas, interpret, enabled):
    assert jax.default_backend() == "cpu"
    eng = EngineConfig(use_pallas=use_pallas, pallas_interpret=interpret)
    assert kernel_enabled(eng) is enabled


def test_gated_out_bucket_takes_xla_loop(monkeypatch):
    """A bucket the gate refuses never reaches the kernel, even with the
    kernel switched on."""
    def boom(*a, **k):
        raise AssertionError("kernel called for a refused bucket")
    monkeypatch.setattr(nmf_gpu, "nmf_masked_gpu", boom)
    F, mask = _bucket(65, 4, 256, (200, 256))
    K1, E1, _ = nmf_masked(F, mask, nmf_tol=1e-4, **KW)
    K2, E2, _ = nmf_masked(F, mask, nmf_tol=1e-4, use_gpu_kernel=True,
                           pallas_interpret=True, **KW)
    np.testing.assert_array_equal(np.asarray(K1), np.asarray(K2))
    np.testing.assert_array_equal(np.asarray(E1), np.asarray(E2))


def test_nmf_tol_xla_adaptive_matches_full_loop():
    """EngineConfig.nmf_tol (opt-in adaptive convergence) on the XLA path:
    at a tight tolerance the frozen-gene loop must stay within the
    power-iteration convergence class of the full fixed-count loop, and
    per-gene freezing must make results invariant to batching (PARITY.md
    known deviation: nmf_tol)."""
    rng = np.random.default_rng(51)
    mats = [random_coverage(rng, 4, L, degraded=(i % 2 == 0)
                            ).astype(np.float32)
            for i, L in enumerate((150, 256, 90, 200))]
    F, mask = make_bucket(mats, 256, dtype=np.float32)
    kw = dict(nmf_iter=50, power_iters_cold=60, power_iters_warm=10)
    K_full, E_full, _ = nmf_masked(F, mask, **kw)
    K_tol, E_tol, _ = nmf_masked(F, mask, nmf_tol=1e-5, **kw)
    np.testing.assert_allclose(np.asarray(K_tol), np.asarray(K_full),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(E_tol), np.asarray(E_full),
                               rtol=1e-3, atol=1e-3)
    # batching invariance: each gene freezes on its own history only
    Ka, Ea, _ = nmf_masked(F[:2], mask[:2], nmf_tol=1e-4, **kw)
    Kb, Eb, _ = nmf_masked(F[2:], mask[2:], nmf_tol=1e-4, **kw)
    K_all, E_all, _ = nmf_masked(F, mask, nmf_tol=1e-4, **kw)
    np.testing.assert_allclose(np.concatenate([Ka, Kb]), np.asarray(K_all),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([Ea, Eb]), np.asarray(E_all),
                               rtol=1e-6, atol=1e-7)


def test_nmf_tol_pallas_matches_xla():
    """nmf_tol > 0 is outside the kernel's gate: with the kernel switched
    on, the adaptive loop runs on XLA and gives the XLA result exactly."""
    F, mask = _bucket(52, 4, 256, (150, 256, 90, 200))
    kw = dict(nmf_iter=30, power_iters_cold=60, power_iters_warm=10,
              nmf_tol=1e-4)
    K1, E1, _ = nmf_masked(F, mask, **kw)
    K2, E2, _ = nmf_masked(F, mask, use_gpu_kernel=True,
                           pallas_interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(K1), np.asarray(K2))
    np.testing.assert_array_equal(np.asarray(E1), np.asarray(E2))


def test_nmf_tol_trim_path_parity():
    """Full baseline selection at nmf_tol > 0 with the kernel switched on
    equals the plain XLA path (the gate keeps nmf_tol on XLA)."""
    F, mask = _bucket(53, 4, 256, (200, 256, 180, 230, 140, 250, 210, 160))
    cfg = NMFConfig(nmf_iter=12)
    r_xla = baseline_select_bucket(
        F, mask, cfg, EngineConfig(use_pallas=False, nmf_tol=1e-4))
    r_pl = baseline_select_bucket(
        F, mask, cfg, EngineConfig(use_pallas=True, pallas_interpret=True,
                                   nmf_tol=1e-4))
    assert int(np.asarray(r_xla.ran_bs).sum()) > 0, "trim loop never ran"
    for a, b in zip(r_xla, r_pl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_trim_loop_with_kernel_matches_xla():
    """The XLA trim loop calling the interpreted kernel (inactive genes
    skipped each round) makes the same decisions as the plain XLA loop,
    with f32-class DI agreement."""
    F, mask = _bucket(46, 4, 256, (200, 256, 180, 230, 140, 250, 210, 160))
    cfg = NMFConfig(nmf_iter=10)
    r_xla = baseline_select_bucket(F, mask, cfg,
                                   EngineConfig(use_pallas=False))
    r_pl = baseline_select_bucket(
        F, mask, cfg, EngineConfig(use_pallas=True, pallas_interpret=True))
    assert int(np.asarray(r_xla.ran_bs).sum()) > 0, "trim loop never ran"
    for name in ("ran_bs", "rounds_active", "est_kind", "bailed"):
        np.testing.assert_array_equal(np.asarray(getattr(r_xla, name)),
                                      np.asarray(getattr(r_pl, name)))
    _close(r_pl.rho, r_xla.rho, rtol=5e-4, atol=5e-5)
    _close(r_pl.est_K, r_xla.est_K, rtol=5e-4, atol=5e-4)
    _close(r_pl.est_E, r_xla.est_E, rtol=5e-4, atol=5e-4)


def test_resume_power_iters_drift():
    """Trim rounds >= 1 resume the cold rank-1 from the previous round's
    left Perron vector at EngineConfig.power_iters_resume iterations
    (PARITY.md known deviation 5). Against the full-iteration warm start
    (resume=power_iters_cold, the superset of the old fresh start) the
    trim decisions must be identical and DI drift tiny."""
    rng = np.random.default_rng(46)
    mats = [random_coverage(rng, 4, L, degraded=(i % 2 == 0)
                            ).astype(np.float32)
            for i, L in enumerate((200, 256, 180, 230, 140, 250, 210, 160))]
    F, mask = make_bucket(mats, 256, dtype=np.float32)
    cfg = NMFConfig(nmf_iter=12)
    r_full = baseline_select_bucket(
        F, mask, cfg, EngineConfig(use_pallas=False, power_iters_resume=128))
    r_resume = baseline_select_bucket(
        F, mask, cfg, EngineConfig(use_pallas=False, power_iters_resume=32))
    assert int(np.asarray(r_full.ran_bs).sum()) > 0, "trim loop never ran"
    np.testing.assert_array_equal(np.asarray(r_full.ran_bs),
                                  np.asarray(r_resume.ran_bs))
    np.testing.assert_array_equal(np.asarray(r_full.rounds_active),
                                  np.asarray(r_resume.rounds_active))
    np.testing.assert_allclose(np.asarray(r_resume.rho),
                               np.asarray(r_full.rho),
                               rtol=1e-3, atol=1e-4)


def test_baseline_bucket_with_pallas_path():
    """The whole bucket step with the interpreted kernel inside must match
    the plain XLA path at float32 tolerance."""
    rng = np.random.default_rng(45)
    mats = [random_coverage(rng, 3, L, degraded=(i % 2 == 0)
                            ).astype(np.float32)
            for i, L in enumerate((210, 300, 450, 128))]
    F, mask = make_bucket(mats, 512, dtype=np.float32)
    cfg = NMFConfig(nmf_iter=6)
    eng_plain = EngineConfig(rank1_method="power", dtype="float32",
                             use_pallas=False)
    eng_pl = dataclasses.replace(eng_plain, use_pallas=True,
                                 pallas_interpret=True)
    r1 = baseline_select_bucket(F, mask, cfg, eng_plain)
    r2 = baseline_select_bucket(F, mask, cfg, eng_pl)
    np.testing.assert_array_equal(np.asarray(r1.ran_bs),
                                  np.asarray(r2.ran_bs))
    np.testing.assert_allclose(np.asarray(r1.rho), np.asarray(r2.rho),
                               rtol=5e-3, atol=5e-4)


@pytest.mark.gpu
def test_kernel_compiled_on_card_matches_xla(gpu_device):
    """The kernel as compiled for the card (no interpreter) against the XLA
    loop at the bench's main bucket width."""
    with jax.enable_x64(False), jax.default_device(gpu_device):
        F, mask = _bucket(66, 8, 1024, tuple(range(300, 1025, 45)))
        K1, E1, _ = jax.jit(lambda F, m: nmf_masked(F, m, **KW))(F, mask)
        K2, E2, _ = nmf_masked_gpu(F, mask, **KW)
        _close(K1, K2)
        _close(E1, E2)
