"""Engine-level A/B of adaptive NMF convergence (EngineConfig.nmf_tol):
full DegNorm fits on the bench workload, comparing steady-iteration time,
DI drift, and baseline-selection DECISION FLIPS against the fixed-count
loop (the gate PARITY.md requires before any default change).

Usage: python tools/nmf_tol_ab.py [n_genes] [profile]
  profile: dense (default) | sparse (bench.py's BENCH_PROFILE values)
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import dataclasses
import time

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
PROFILE = sys.argv[2] if len(sys.argv) > 2 else "dense"

import bench
from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.engine import DegNormEngine

cov, X = bench.synth_dataset(N, 8, profile=PROFILE)
nmf_cfg = NMFConfig(nmf_iter=50, degnorm_iter=3)
base_eng = EngineConfig(bucket_widths=(1024, 4096))

results = {}
for name, tol in [("tol_0", 0.0), ("tol_1e-4", 1e-4), ("tol_1e-3", 1e-3),
                  ("tol_1e-2", 1e-2)]:
    eng_cfg = dataclasses.replace(base_eng, nmf_tol=tol)
    eng = DegNormEngine(nmf_cfg, eng_cfg)
    res = eng.run(cov, X)          # first run warms compiles for this cfg
    eng = DegNormEngine(nmf_cfg, eng_cfg)
    t0 = time.perf_counter()
    res = eng.run(cov, X)
    dt = time.perf_counter() - t0
    iters = {k: v for k, v in eng.timings.items() if k.startswith("iter_")}
    steady = min(v for k, v in iters.items() if k != "iter_0") \
        if len(iters) > 1 else max(iters.values())
    results[name] = (np.asarray(res.rho),
                     np.asarray(res.ran_baseline_selection), dt, steady)
    print(f"{name:>9s}: fit {dt:5.1f}s  steady-iter {steady:5.2f}s",
          flush=True)

rho0, ran0, _, _ = results["tol_0"]
for name, (rho, ran, _, _) in results.items():
    if name == "tol_0":
        continue
    d = np.abs(rho - rho0)
    flips = int((ran != ran0).sum())
    print(f"{name:>9s} vs tol_0: DI maxabs {d.max():.2e} mean {d.mean():.2e}"
          f"  decision flips {flips}/{ran0.size}", flush=True)
