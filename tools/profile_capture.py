"""Trace the steady DegNorm iterations on one GPU and print device time per
kernel.

Usage: python tools/profile_capture.py [n_genes] [n_samples] [--out DIR]

Warms every compile with an untraced fit, then traces one steady refit
(``EngineConfig.profile_dir``) and reads the trace back with
``jax.profiler.ProfileData``: for every device plane (``/device:GPU:*``) it
sums event durations by name over all lines, and reports the device busy
share of the traced window (union of event intervals over the window).
The raw ``.xplane.pb`` stays under DIR (default: a new temporary
directory; traces run to tens of MB).
"""
import argparse
import collections
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summarize(xplane_path: str, top: int = 25) -> None:
    from jax.profiler import ProfileData
    data = ProfileData.from_file(xplane_path)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        totals = collections.Counter()
        counts = collections.Counter()
        spans = []
        for line in plane.lines:
            for ev in line.events:
                totals[ev.name] += ev.duration_ns
                counts[ev.name] += 1
                spans.append((ev.start_ns, ev.end_ns))
        if not spans:
            continue
        spans.sort()
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        print(f"{plane.name}: window {window / 1e6:.1f} ms, busy "
              f"{busy / 1e6:.1f} ms ({busy / max(window, 1):.1%})")
        for name, ns in totals.most_common(top):
            print(f"  {ns / 1e6:10.3f} ms  {counts[name]:6d}x  {name[:100]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_genes", nargs="?", type=int, default=20480)
    ap.add_argument("n_samples", nargs="?", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import dataclasses

    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("profile_capture needs a GPU")
    import bench
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine

    N, P = args.n_genes, args.n_samples
    trace_dir = args.out or tempfile.mkdtemp(prefix=f"dn_trace_{N}x{P}_")
    cov, X = bench.synth_dataset(N, P)
    nmf_cfg = NMFConfig(nmf_iter=100, degnorm_iter=3)
    eng_cfg = EngineConfig()
    DegNormEngine(nmf_cfg, eng_cfg).run(cov, X)          # warm compiles
    eng = DegNormEngine(nmf_cfg,
                        dataclasses.replace(eng_cfg, profile_dir=trace_dir))
    t0 = time.perf_counter()
    eng.run(cov, X)
    print(f"traced fit: {time.perf_counter() - t0:.1f}s timings="
          f"{ {k: round(v, 3) for k, v in eng.timings.items()} }")
    planes = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                              recursive=True))
    if not planes:
        raise SystemExit(f"no trace written under {trace_dir}")
    summarize(planes[-1])


if __name__ == "__main__":
    main()
