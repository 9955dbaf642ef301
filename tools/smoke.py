"""Pre-commit smoke gate (<2 min, CPU) — run before ANY snapshot/commit that
touches core/, ops/, parallel/ or engine.py.

Exercises every kernel call signature end-to-end:
  1. one engine fit with the GPU NMF kernel (ops/nmf_gpu.py) in the Pallas
     interpreter — the plumbing the GPU path uses, minus Triton codegen;
  2. one engine fit on the plain XLA path, cross-checked against (1);
  3. the nmf_tol opt-in with the kernel switched on (it takes XLA);
  4. the device-resident outer loop, interpreted kernel included;
  5. dryrun_multichip(2) — the gene-sharded shard_map step, kernel included.

This is the automated gate the reference gets from Travis + degnorm_test
(reference .travis.yml:8-11, tests/__test__.py:33-35).  Round 2 shipped a
kernel-signature break (nmf_tol TypeError) that any of these three calls
would have caught in seconds; do not skip it.

Usage:  python tools/smoke.py     (exit 0 = green)
"""
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=2").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def synthetic_dataset(n=24, p=4, seed=7):
    # Deliberately NOT bench.synth_dataset: smoke must stay ~1 min on CPU,
    # so gene lengths are capped at 600 (the interpreted kernel's cost
    # scales with the padded bucket width; bench's 200-4000 bp power law
    # would quadruple the gate's runtime for no extra signature coverage).
    rng = np.random.default_rng(seed)
    cov, counts = {}, []
    for i in range(n):
        L = int(rng.integers(150, 600))
        t = np.linspace(0, 1, L)
        base = np.abs(np.sin(np.pi * t)) + 0.05
        amp = 0.5 + rng.random((p, 1)) * 4
        decay = np.exp(-t[None, :] * rng.random((p, 1)) * (i % 3))
        F = np.rint(base[None, :] * amp * decay * 20).astype(np.float64)
        cov[f"g{i}"] = F
        counts.append(F.sum(axis=1) + 1)
    return cov, np.asarray(counts)


def main():
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine

    t0 = time.time()
    cov, counts = synthetic_dataset()
    nmf_cfg = NMFConfig(nmf_iter=10, degnorm_iter=2)

    # 1. GPU-kernel plumbing (interpreted: same call signatures as the GPU)
    eng_pl = DegNormEngine(nmf_cfg, EngineConfig(
        use_pallas=True, pallas_interpret=True))
    res_pl = eng_pl.run(cov, counts)
    assert np.isfinite(res_pl.rho).all() and res_pl.ran_baseline_selection.any()
    print(f"[smoke] kernel-interpret fit ok  ({time.time() - t0:.1f}s)")

    # 2. XLA path + HOST f64 outer loop (device_loop=False: the None
    #    default resolves to the device loop since round 4, and step 4's
    #    cross-check needs the host loop actually exercised)
    eng_x = DegNormEngine(nmf_cfg, EngineConfig(use_pallas=False,
                                                device_loop=False))
    res_x = eng_x.run(cov, counts)
    np.testing.assert_allclose(res_pl.rho, res_x.rho, rtol=5e-3, atol=5e-4)
    np.testing.assert_array_equal(res_pl.ran_baseline_selection,
                                  res_x.ran_baseline_selection)
    print(f"[smoke] xla fit + parity ok      ({time.time() - t0:.1f}s)")

    # 3. adaptive-convergence opt-in (nmf_tol) on both paths
    eng_t = DegNormEngine(nmf_cfg, EngineConfig(
        use_pallas=True, pallas_interpret=True, nmf_tol=1e-4))
    res_t = eng_t.run(cov, counts)
    np.testing.assert_allclose(res_t.rho, res_x.rho, rtol=5e-2, atol=5e-3)
    print(f"[smoke] nmf_tol fit ok           ({time.time() - t0:.1f}s)")

    # 4. device-resident outer loop (single-process path incl. the
    #    presort/reorder fetches), cross-checked against the host loop
    eng_d = DegNormEngine(nmf_cfg, EngineConfig(
        use_pallas=True, pallas_interpret=True, device_loop=True))
    res_d = eng_d.run(cov, counts)
    np.testing.assert_array_equal(res_d.ran_baseline_selection,
                                  res_x.ran_baseline_selection)
    np.testing.assert_allclose(res_d.rho, res_x.rho, rtol=5e-3, atol=5e-4)
    print(f"[smoke] device-loop fit ok       ({time.time() - t0:.1f}s)")

    # 5. multichip dryrun (gene-sharded shard_map step, kernel included)
    import __graft_entry__ as g
    g.dryrun_multichip(2)
    print(f"[smoke] dryrun_multichip(2) ok   ({time.time() - t0:.1f}s)")
    print("[smoke] GREEN")


if __name__ == "__main__":
    main()
