"""DegNorm fit benchmark on one GPU: NMF-OA gene-iteration throughput.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "device": {...}, ...}

Workload (BASELINE.md config 3 ladder): full algorithm (baseline selection +
over-approximation) on a synthetic multi-bucket dataset.  ``vs_baseline``
times the reference implementation (imported read-only from
/root/reference, pure CPU) on a subsample of the same genes with identical
parameters and reports ours/theirs in gene-iterations/sec; it is null when
the reference is absent.

The timed window is the STEADY-STATE fit — the engine's device-resident
outer loop re-fitting the already uploaded dataset
(``run(reuse_device_data=True)``), init through final gathers included.
The one-time pack + host->device upload and all compiles are paid by the
untimed warmup run and reported separately (``upload_wall_s``,
``warmup_wall_s``).  ``BENCH_COLD=1`` times fresh engines instead (upload
inside the window).  The run refuses to start without a GPU: a CPU number
is never reported under a device metric.
"""
import json
import os
import sys
import time
from collections import OrderedDict

import numpy as np

N_GENES = int(os.environ.get("BENCH_GENES", 20480))
P_SAMPLES = int(os.environ.get("BENCH_SAMPLES", 8))
NMF_ITER = int(os.environ.get("BENCH_NMF_ITER", 50))
DEGNORM_ITER = int(os.environ.get("BENCH_DEGNORM_ITER", 5))
REF_GENES = int(os.environ.get("BENCH_REF_GENES", 24))
# best-of-N steady refits
REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
SKIP_BS = os.environ.get("BENCH_SKIP_BS", "0") == "1"
# A/B hook for the opt-in adaptive NMF convergence (EngineConfig.nmf_tol)
NMF_TOL = float(os.environ.get("BENCH_NMF_TOL", "0"))
# "dense": every gene degrades (worst case — most genes trim deep).
# "sparse": ~20% degrade (the realistic regime; most genes leave the trim
# loop immediately, which the GPU kernel's per-gene skipping exploits).
PROFILE = os.environ.get("BENCH_PROFILE", "dense")


def synth_lengths(n, seed=7, rng=None):
    """Power-law-ish gene lengths, 200..4000 bp (two bucket widths; keeps
    the number of distinct kernel shapes — and compiles — small).  Pass
    ``rng`` to draw from an existing stream (synth_dataset does, so its
    downstream draws are unchanged)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    return np.clip((rng.pareto(1.7, n) + 1) * 220, 200, 4000).astype(int)


def synth_dataset(n, p, seed=7, profile=PROFILE, lengths=None):
    """Synthetic pileup-like dataset, vectorized over genes of one length
    (the per-gene Python-loop form cost ~36 s at 20k genes / ~60 s at 50k
    of pure interpreter overhead before any timed work).  ``lengths``
    overrides the drawn gene lengths (the draws that follow are unchanged)."""
    rng = np.random.default_rng(seed)
    drawn = synth_lengths(n, rng=rng)
    lengths = drawn if lengths is None else np.asarray(lengths, int)
    degraded = (np.ones(n, bool) if profile == "dense"
                else rng.random(n) < 0.2)
    base_scale = 2 + 10 * rng.random(n)
    amp = 0.5 + rng.random((n, p)) * 1.5
    decay = rng.random((n, p))
    mats = [None] * n
    odd = (np.arange(p) % 2 == 1)[None, :, None]
    order = np.argsort(lengths, kind="stable")   # slice Lmax ~ slice max
    for s in range(0, n, 512):
        idx = order[s:s + 512]
        Lk = lengths[idx][:, None].astype(np.float64)       # (k, 1)
        Lmax = int(lengths[idx].max())
        j = np.arange(Lmax, dtype=np.float64)[None, :]
        t = j / (Lk - 1)                                    # == linspace
        base = np.abs(np.sin(np.pi * t) + 0.2)              # (k, Lmax)
        m = (amp[idx][:, :, None] * base_scale[idx][:, None, None]
             * base[:, None, :])                            # (k, p, Lmax)
        dec = np.exp(-2.0 * (1 - t)[:, None, :] * decay[idx][:, :, None])
        m = np.where(degraded[idx][:, None, None] & odd, m * dec, m)
        # integer coverage (like real read pileups) — rides the engine's
        # compressed upload path; float32 halves host memory at 50k-gene
        # scale (values integral, far below 2^24)
        m = np.round(np.maximum(m, 0.0) * 20).astype(np.float32)
        for k, gi in enumerate(idx):
            mats[gi] = np.ascontiguousarray(m[k, :, :int(lengths[gi])])
    cov = OrderedDict((f"g{i}", mats[i]) for i in range(n))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def time_reference(cov, X, m):
    """Time the reference GeneNMFOA on the first m genes (CPU, 1 thread)."""
    import types
    if "pkg_resources" not in sys.modules:
        stub = types.ModuleType("pkg_resources")
        stub.resource_filename = lambda *a, **k: "/dev/null"
        sys.modules["pkg_resources"] = stub
    sys.path.append("/root/reference")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from degnorm.nmf import GeneNMFOA
    genes = list(cov.keys())[:m]
    sub = OrderedDict((g, cov[g].copy()) for g in genes)
    Xs = X[:m].copy()
    # one DegNorm iteration on a small subsample is enough to measure the
    # reference's per-gene-iteration cost (it is linear in both)
    # mirror the engine's configuration (skip-BS must apply to BOTH sides
    # or vs_baseline compares different algorithms)
    o = GeneNMFOA(degnorm_iter=1, nmf_iter=NMF_ITER, n_jobs=1,
                  skip_baseline_selection=SKIP_BS)
    t0 = time.perf_counter()
    o.run(sub, Xs)
    dt = time.perf_counter() - t0
    return m / dt


def device_info():
    """The device every number of this run comes from: JAX's platform,
    kind and count, and the card's name and power limit from nvidia-smi
    (a card below its maximum power limit runs slower under load).
    Raises unless JAX's default device is a GPU."""
    import subprocess
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    name, power = (smi[0].split(",", 1) + [""])[:2]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": name.strip(),
            "power_limit": power.strip()}


def main():
    device = device_info()
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine

    t0 = time.perf_counter()
    cov, X = synth_dataset(N_GENES, P_SAMPLES)
    print(f"[bench] synth: {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER,
                        skip_baseline_selection=SKIP_BS)
    eng_cfg = EngineConfig(
        bucket_widths=(1024, 4096), nmf_tol=NMF_TOL,
        # A/B hook: opt back into the host f64 outer loop (the default is
        # the device-resident loop with double-float outer updates)
        device_loop=(False if os.environ.get("BENCH_HOST_LOOP") == "1"
                     else None))
    cold = os.environ.get("BENCH_COLD") == "1"

    # Untimed warmup: one FULL run on the same engine — compiles every
    # kernel variant (intermediate + final iteration) into the in-process
    # and persistent caches AND leaves the packed buckets device-resident,
    # so the timed refits below measure engine throughput, not compilation
    # or upload.
    t0 = time.perf_counter()
    engine = DegNormEngine(nmf_cfg, eng_cfg)
    engine.run(cov, X)
    warm_wall = time.perf_counter() - t0
    upload_wall = sum(engine.timings.get(k, 0.0)
                      for k in ("pack", "encode_upload"))
    print(f"[bench] warmup (full run incl. pack+upload): {warm_wall:.1f}s, "
          f"timings: { {k: round(v, 2) for k, v in engine.timings.items()} }",
          file=sys.stderr, flush=True)

    # Timed runs (best of REPEATS): steady-state refits on the device-
    # resident buckets (BENCH_COLD=1: fresh engine per repeat, upload
    # inside the window — the pre-round-4 definition).
    dt = float("inf")
    timings = {}
    for r in range(max(REPEATS, 1)):
        if cold:
            engine = DegNormEngine(nmf_cfg, eng_cfg)
        t0 = time.perf_counter()
        engine.run(cov, X, reuse_device_data=not cold)
        dt_r = time.perf_counter() - t0
        print(f"[bench] run {r}: {dt_r:.1f}s, engine timings: "
              f"{ {k: round(v, 2) for k, v in engine.timings.items()} }",
              file=sys.stderr, flush=True)
        if dt_r < dt:
            dt, timings = dt_r, dict(engine.timings)
    ours = N_GENES * DEGNORM_ITER / dt

    # One dedicated COLD repeat (fresh engine: pack + upload + init inside
    # the wall; kernels already compiled) so every BENCH_r*.json carries
    # BOTH windows and cold-vs-steady stays comparable across rounds
    # without a manual BENCH_COLD run.  With BENCH_COLD=1 the timed loop
    # above is already cold and this would duplicate it.
    if not cold:
        t0 = time.perf_counter()
        DegNormEngine(nmf_cfg, eng_cfg).run(cov, X)
        cold_wall = time.perf_counter() - t0
        print(f"[bench] cold run (fresh engine): {cold_wall:.1f}s",
              file=sys.stderr, flush=True)
    else:
        cold_wall = dt
    ours_cold = N_GENES * DEGNORM_ITER / cold_wall

    try:
        ref = time_reference(cov, X, REF_GENES)
    except Exception as e:
        print(f"[bench] reference timing failed: {e}", file=sys.stderr)
        ref = None

    out = {
        "metric": "nmfoa_gene_iterations_per_sec",
        "value": round(ours, 2),
        "unit": f"gene-iter/s ({N_GENES} genes x {P_SAMPLES} samples, "
                f"nmf_iter={NMF_ITER}, {DEGNORM_ITER} DegNorm iters, "
                f"wall {dt:.1f}s best-of-{max(REPEATS, 1)} "
                + ("incl. pack+upload"
                   if cold else "steady-state device-resident fit") + ")",
        # ratio windows: vs_baseline divides the steady-state rate by the
        # reference's (necessarily cold, per-run) CPU rate;
        # vs_baseline_cold uses OUR cold window too — apples-to-apples
        # with the reference's own run shape (ADVICE r4).
        "vs_baseline": round(ours / ref, 2) if ref else None,
        "cold_wall_s": round(cold_wall, 1),
        "value_cold": round(ours_cold, 2),
        "vs_baseline_cold": round(ours_cold / ref, 2) if ref else None,
        # one-time dataset costs, outside the steady window; upload
        # completion overlaps the warmup's init, so warmup_wall_s (which
        # also holds compile time) is the conservative upper bound.
        "upload_wall_s": round(upload_wall, 2),
        "warmup_wall_s": round(warm_wall, 1),
        "timings": {k: round(v, 3) for k, v in timings.items()},
        "device": device,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
