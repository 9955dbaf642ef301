"""Engine-level A/B of trim-round cold-start resume (power_iters_resume):
full DegNorm fits on the bench workload comparing steady-iteration time and
DI drift for fresh 128-iteration cold starts vs warm-resumed starts at
32/16 power iterations (one process, shared device session).

Usage: python tools/resume_ab.py [n_genes]
"""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import dataclasses
import time

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 4096

import bench
from degnorm_jax.config import EngineConfig, NMFConfig
from degnorm_jax.engine import DegNormEngine

cov, X = bench.synth_dataset(N, 8)
nmf_cfg = NMFConfig(nmf_iter=50, degnorm_iter=3)
base_eng = EngineConfig(bucket_widths=(1024, 4096))

results = {}
# resume=128 == the old fresh-start behavior (same iteration count, warm
# u0 makes it a superset; use 0 to disable entirely if config supports it)
for name, resume in [("cold128", 128), ("resume32", 32), ("resume16", 16)]:
    eng_cfg = dataclasses.replace(base_eng, power_iters_resume=resume)
    eng = DegNormEngine(nmf_cfg, eng_cfg)
    res = eng.run(cov, X)          # warm compiles for this cfg
    eng = DegNormEngine(nmf_cfg, eng_cfg)
    t0 = time.perf_counter()
    res = eng.run(cov, X)
    dt = time.perf_counter() - t0
    iters = {k: v for k, v in eng.timings.items() if k.startswith("iter_")}
    steady = min(v for k, v in iters.items() if k != "iter_0") \
        if len(iters) > 1 else max(iters.values())
    results[name] = (np.asarray(res.rho), dt, steady)
    print(f"{name:>9s}: fit {dt:5.1f}s  steady-iter {steady:5.2f}s",
          flush=True)

rho0 = results["cold128"][0]
for name in ("resume32", "resume16"):
    d = np.abs(results[name][0] - rho0)
    print(f"{name} DI drift vs cold128: max {d.max():.2e} mean {d.mean():.2e}")
