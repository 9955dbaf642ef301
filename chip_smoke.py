#!/usr/bin/env python3
"""On-card proof that the DegNorm fit runs on an NVIDIA GPU.

    python chip_smoke.py              # one card: phases 1-5
    python chip_smoke.py --cards 4    # four cards: the gene mesh only

One process, the only one that touches the card(s).  Every phase prints
its numbers on its own line; any failed check raises, so the script exits
non-zero and never prints the final line.  The last line of a passing run
is one JSON object naming the device as JAX reports it.  Without a GPU
(JAX falls back to the CPU) the script exits 2 before any phase.

Phases (one card):
  1. device: JAX's devices and the card's name and power limit;
  2. kernel: the Pallas GPU NMF kernel (ops/nmf_gpu.py) against the XLA
     loop (core/nmf.py) at every admitted bench bucket shape, parity and
     timing in turns (kernel, XLA, XLA, kernel);
  3. engine: the full fit, 20,480 genes x 8 samples, nmf_iter=100, five
     DegNorm iterations: cold and steady times, peak device memory, the
     kernel fit against the XLA fit, and the device outer loop against
     the host float64 loop;
  4. oracle: a 64-gene subset against the float64 host oracle;
  5. wide: 512 genes of 5,000-80,000 positions (the 8192/16384/65536
     buckets and one exact-width outlier bucket, all on the XLA loop).

With ``--cards 4``: the phase-3 fit on a 1-D gene mesh over four cards
against a one-card fit, and one column-sharded (seqpar) bucket through
the GSPMD path against a one-card fit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import OrderedDict

import numpy as np

N_GENES, P_SAMPLES = 20480, 8
NMF_ITER, DEGNORM_ITER = 100, 5
# kernel vs XLA, per NMF call (tests/test_pallas.py's bar)
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# kernel fit vs XLA fit, and mesh fit vs one-card fit
MAX_FLIP_SHARE, RHO_ATOL = 1e-3, 5e-3
# device loop vs host float64 loop (tests/test_checkpoint_mesh.py)
LOOP_RTOL = 5e-5
# f32 fit vs the float64 oracle (tests/test_engine.py)
ORACLE_ATOL = 5e-3
WIDE_GENES = 512


def card_lines() -> list:
    """nvidia-smi's name and power limit, read by a child process before
    JAX touches a card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def excess(a, b, rtol, atol) -> float:
    """max |a - b| / (atol + rtol |b|): <= 1 passes allclose."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b)),
                        initial=0.0))


def compare_fits(phase, fit, ref, n):
    """The fit gates.  A gene "flips" when its ran_baseline_selection row
    differs, or when its rho moves by more than RHO_ATOL: f32 rounding can
    tip the trim loop's argmax to another bin at a borderline gene, which
    changes that gene's rho by up to ~2e-2 with the same decision flags.
    At most MAX_FLIP_SHARE of the genes may flip; on the rest rho agrees
    within RHO_ATOL by construction, and the largest such difference is
    printed."""
    ran = np.any(fit.ran_baseline_selection != ref.ran_baseline_selection,
                 axis=1)
    drho = np.max(np.abs(fit.rho - ref.rho), axis=1)
    moved = ~ran & (drho > RHO_ATOL)
    rest = ~(ran | moved)
    say(phase, genes=n, ran_bs_flip_genes=int(ran.sum()),
        rho_moved_genes=int(moved.sum()),
        flip_share=f"{(ran | moved).mean():.2e}",
        rho_max_abs_diff_all=f"{drho.max():.3e}",
        rho_max_abs_diff_rest=f"{drho[rest].max(initial=0.0):.3e}",
        rho_p999=f"{np.quantile(drho, 0.999):.3e}",
        limits=f"flip_share<={MAX_FLIP_SHARE},rho<={RHO_ATOL}")
    check((ran | moved).mean() <= MAX_FLIP_SHARE, f"{phase}: too many flips")


def bench_dataset(p, lengths=None, n=None):
    from bench import synth_dataset
    return synth_dataset(n or N_GENES, p, profile="dense", lengths=lengths)


# ---------------------------------------------------------------- phase 2
def phase_kernel():
    import jax
    from degnorm_jax.config import EngineConfig
    from degnorm_jax.core.nmf import nmf_masked
    from degnorm_jax.ops.nmf_gpu import kernel_supported, nmf_masked_gpu

    eng = EngineConfig()
    kw = dict(nmf_iter=NMF_ITER, power_iters_cold=eng.power_iters_cold,
              power_iters_warm=eng.power_iters_warm)
    xla = jax.jit(lambda F, m: nmf_masked(F, m, **kw))
    kern = jax.jit(lambda F, m: nmf_masked_gpu(F, m, **kw))
    for p in (8, 16, 32):
        mats = None
        for lo, W in ((0, 1024), (1024, 4096)):
            if not kernel_supported((1, p, W), np.float32):
                say("kernel", p=p, W=W, route="xla (refused by the gate)")
                continue
            if mats is None:
                mats = list(bench_dataset(p)[0].values())
            sel = [m for m in mats if lo < m.shape[1] <= W]
            F = np.zeros((len(sel), p, W), np.float32)
            mask = np.zeros((len(sel), W), bool)
            for i, m in enumerate(sel):
                F[i, :, :m.shape[1]] = m
                mask[i, :m.shape[1]] = True
            F, mask = jax.device_put(F), jax.device_put(mask)
            t0 = time.perf_counter()
            got = jax.block_until_ready(kern(F, mask))
            first_k = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = jax.block_until_ready(xla(F, mask))
            first_x = time.perf_counter() - t0
            ek = excess(got[0], ref[0], KERNEL_RTOL, KERNEL_ATOL)
            ee = excess(got[1], ref[1], KERNEL_RTOL, KERNEL_ATOL)
            times = {"kernel": [], "xla": []}
            for name in ("kernel", "xla", "xla", "kernel"):
                fn = kern if name == "kernel" else xla
                t0 = time.perf_counter()
                jax.block_until_ready(fn(F, mask))
                times[name].append(time.perf_counter() - t0)
            say("kernel", p=p, W=W, G=len(sel),
                K_excess=f"{ek:.3g}", E_excess=f"{ee:.3g}",
                tol=f"rtol={KERNEL_RTOL},atol={KERNEL_ATOL}",
                first_call_s=f"kernel:{first_k:.3f},xla:{first_x:.3f}",
                kernel_s=",".join(f"{t:.4f}" for t in times["kernel"]),
                xla_s=",".join(f"{t:.4f}" for t in times["xla"]))
            check(ek <= 1 and ee <= 1, f"kernel parity p={p} W={W}")


# ---------------------------------------------------------------- phase 3
def phase_engine():
    import jax
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine

    cov, X = bench_dataset(P_SAMPLES)
    nmf = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    engines = {"kernel": DegNormEngine(nmf, EngineConfig()),
               "xla": DegNormEngine(nmf, EngineConfig(use_pallas=False))}
    fits, cold = {}, {}
    for name, eng in engines.items():
        t0 = time.perf_counter()
        fits[name] = eng.run(cov, X)
        cold[name] = time.perf_counter() - t0
    steady = {"kernel": [], "xla": []}
    for name in ("kernel", "xla", "xla", "kernel"):
        t0 = time.perf_counter()
        fits[name] = engines[name].run(cov, X, reuse_device_data=True)
        steady[name].append(time.perf_counter() - t0)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    gi = N_GENES * DEGNORM_ITER
    say("engine", genes=N_GENES, samples=P_SAMPLES, nmf_iter=NMF_ITER,
        degnorm_iter=DEGNORM_ITER,
        cold_s=f"kernel:{cold['kernel']:.2f},xla:{cold['xla']:.2f}",
        steady_kernel_s=",".join(f"{t:.3f}" for t in steady["kernel"]),
        steady_xla_s=",".join(f"{t:.3f}" for t in steady["xla"]),
        gene_iter_per_s=f"kernel:{gi / min(steady['kernel']):.0f},"
                        f"xla:{gi / min(steady['xla']):.0f}",
        peak_bytes_in_use=peak)
    say("engine", kernel_fit_timings={k: round(v, 3) for k, v in
                                      engines["kernel"].timings.items()})
    compare_fits("engine kernel-vs-xla", fits["kernel"], fits["xla"],
                 N_GENES)
    host = DegNormEngine(nmf, EngineConfig(device_loop=False)).run(cov, X)
    dev = fits["kernel"]
    flips = int(np.any(dev.ran_baseline_selection
                       != host.ran_baseline_selection, axis=1).sum())
    ex = {"x_adj": excess(dev.x_adj, host.x_adj, LOOP_RTOL, 1e-8),
          "rho": excess(dev.rho, host.rho, LOOP_RTOL, 1e-6),
          "scale": excess(dev.scale_factors, host.scale_factors,
                          LOOP_RTOL, 0.0)}
    say("engine device-vs-host-loop", bs_flip_genes=flips,
        **{f"{k}_excess": f"{v:.3g}" for k, v in ex.items()},
        tol=f"rtol={LOOP_RTOL}")
    check(flips == 0 and max(ex.values()) <= 1, "device loop vs host loop")
    return cov, X


# ---------------------------------------------------------------- phase 4
def phase_oracle(cov, X):
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine
    from degnorm_jax.oracle import nmfoa as oracle

    genes = list(cov)[:64]
    sub = OrderedDict((g, cov[g]) for g in genes)
    cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=2)
    res = DegNormEngine(cfg, EngineConfig()).run(sub, X[:64])
    t0 = time.perf_counter()
    gold = oracle.degnorm_fit(list(sub.values()), X[:64], cfg)
    drho = float(np.max(np.abs(res.rho - gold.rho)))
    dx = float(np.max(np.abs(res.x_adj / gold.x_adj - 1.0)))
    say("oracle", genes=64, degnorm_iter=2, rho_max_abs_diff=f"{drho:.3e}",
        x_adj_max_rel_diff=f"{dx:.3e}", limit=ORACLE_ATOL,
        oracle_host_s=f"{time.perf_counter() - t0:.1f}")
    check(drho <= ORACLE_ATOL and dx <= ORACLE_ATOL, "oracle anchor")


# ---------------------------------------------------------------- phase 5
def wide_dataset(seed=11):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5000, 60001, WIDE_GENES)
    lengths[:4] = 80000        # one exact-width outlier bucket (> 65536)
    return bench_dataset(P_SAMPLES, lengths=lengths, n=WIDE_GENES)


def phase_wide():
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine
    from degnorm_jax.ops.nmf_gpu import kernel_supported

    cov, X = wide_dataset()
    eng = DegNormEngine(NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=2),
                        EngineConfig())
    t0 = time.perf_counter()
    res = eng.run(cov, X)
    widths = [b.width for b in eng._buckets]
    routes = ["kernel" if kernel_supported(b.F.shape, np.float32) else "xla"
              for b in eng._buckets]
    say("wide", genes=len(cov), widths=widths, routes=routes,
        wall_s=f"{time.perf_counter() - t0:.1f}",
        rho_min=f"{res.rho.min():.4f}", rho_max=f"{res.rho.max():.4f}")
    check(set(routes) == {"xla"}, "wide buckets must take the XLA loop")
    check(np.isfinite(res.rho).all() and np.isfinite(res.x_adj).all(),
          "wide: non-finite output")
    check(res.rho.min() >= 0 and res.rho.max() <= 0.9, "wide: rho range")


# ---------------------------------------------------------------- 4 cards
def phase_mesh(n_cards):
    import jax
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine
    from degnorm_jax.parallel.sharded import make_mesh

    check(len(jax.devices()) >= n_cards, f"needs {n_cards} cards")
    mesh = make_mesh(jax.devices()[:n_cards])
    nmf = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    cov, X = bench_dataset(P_SAMPLES)
    walls = {}
    fits = {}
    for name, m in (("one_card", None), ("mesh", mesh)):
        eng = DegNormEngine(nmf, EngineConfig(), mesh=m)
        eng.run(cov, X)                       # compiles
        t0 = time.perf_counter()
        fits[name] = eng.run(cov, X, reuse_device_data=True)
        walls[name] = time.perf_counter() - t0
    say("mesh", cards=n_cards, genes=N_GENES,
        steady_s=f"one_card:{walls['one_card']:.3f},"
                 f"mesh:{walls['mesh']:.3f}")
    compare_fits("mesh gene-sharded", fits["mesh"], fits["one_card"],
                 N_GENES)

    # column-sharded (seqpar) bucket: every gene wider than seqpar_width
    rng = np.random.default_rng(13)
    seq = EngineConfig().seqpar_width
    lengths = rng.integers(seq + 1, 60001, 64)
    cov, X = bench_dataset(P_SAMPLES, lengths=lengths, n=64)
    cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=2)
    one = DegNormEngine(cfg, EngineConfig()).run(cov, X)
    eng = DegNormEngine(cfg, EngineConfig(), mesh=mesh)
    sharded = eng.run(cov, X)
    check(not any(eng._bucket_gene_sharded), "expected column sharding")
    say("mesh seqpar", widths=[b.width for b in eng._buckets])
    compare_fits("mesh column-sharded", sharded, one, 64)


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    say(name, phase_wall_s=f"{time.perf_counter() - t0:.1f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card gene-mesh check")
    args = ap.parse_args(argv)

    try:
        cards = card_lines()             # before JAX touches a card
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: needs a GPU host ({e})", file=sys.stderr)
        return 2
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    say("device", devices=devices, kind=devices[0].device_kind,
        count=len(devices))
    for line in cards:                   # exactly as nvidia-smi prints it
        print(line, flush=True)

    t_all = time.perf_counter()
    if args.cards == 4:
        timed("mesh", phase_mesh, 4)
    else:
        timed("kernel", phase_kernel)
        cov, X = timed("engine", phase_engine)
        timed("oracle", phase_oracle, cov, X)
        timed("wide", phase_wide)
    say("total", wall_s=f"{time.perf_counter() - t_all:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
