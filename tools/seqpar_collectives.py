"""Count the collectives GSPMD emits for a column-sharded (seqpar) bucket
step, to settle whether the dedicated one-psum-per-rank-1 shard_map kernel
(parallel/seqpar.py) buys anything over the engine's actual GSPMD path.

Theoretical minimum for the XLA trim-loop body on a W-sharded bucket:
every reduction along W (the Gram einsum of each rank-1, row sums, column
max, per-bin sums) needs exactly one all-reduce; nothing else communicates
(K, u, rho, bin state are (G, p)/(G, B)-sized and replicated).  The NMF
inner loop therefore needs nmf_iter all-reduces — the same count the
dedicated kernel achieves.  If GSPMD's emitted count matches this bound,
the dedicated kernel is redundant; if GSPMD replicates the big arrays or
emits per-element collectives, the kernel earns its keep.

Usage: python tools/seqpar_collectives.py   (CPU, 8-virtual-device mesh)
"""
import os
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from degnorm_jax.config import EngineConfig, NMFConfig  # noqa: E402
from degnorm_jax.engine import _bucket_step  # noqa: E402
from degnorm_jax.parallel.seqpar import shard_columns  # noqa: E402
from degnorm_jax.parallel.sharded import make_mesh  # noqa: E402

NMF_ITER = 10
G, p, W = 8, 4, 2048

rng = np.random.default_rng(3)
t = np.linspace(0, 1, W)
F = (np.abs(np.sin(np.pi * t))[None, None, :]
     * (1 + rng.random((G, p, 1))) * 20).astype(np.float32)
lengths = rng.integers(W // 2, W + 1, size=G)
mask = (np.arange(W)[None, :] < lengths[:, None])
F = np.round(F * mask[:, None, :])

mesh = make_mesh(axis="genes")
F_s = shard_columns(np.asarray(F), mesh)
m_s = shard_columns(np.asarray(mask), mesh)

nmf_cfg = NMFConfig(nmf_iter=NMF_ITER)
eng_cfg = EngineConfig()         # column_sharded strips Pallas internally
scale = np.ones((p,), np.float32)
ds = np.zeros((G,), np.int32)

lowered = _bucket_step.lower(F_s, m_s, scale, ds, nmf_cfg.kernel_key(),
                             eng_cfg, True, None, "genes", True)
compiled = lowered.compile()
hlo = compiled.as_text()

counts = {}
for op in ("all-reduce", "all-gather", "collective-permute",
           "reduce-scatter", "all-to-all"):
    counts[op] = len(re.findall(rf"{op}(?:-start)?\.?\d* = ", hlo))
# while-loop trip counts are opaque; report static occurrences + loop info
n_while = hlo.count(" while(")
print(f"shapes G={G} p={p} W={W} nmf_iter={NMF_ITER}, mesh=8 devices")
print("static HLO collective ops:", counts)
print("while loops in module:", n_while)

# Show each all-reduce's operand tuple: GSPMD FUSES independent
# same-group reductions into single variadic collectives (e.g. the rank-1
# Gram and a row sum ride one all-reduce) — strictly better than the
# deleted hand kernel's one-psum-per-rank-1, which is the point this tool
# exists to evidence.
for m in re.finditer(r"%all-reduce\.?\d* = (\([^)]*\)|\S+) all-reduce",
                     hlo):
    ops = m.group(1)
    n_fused = len(re.findall(r"[a-z]\d+\[", ops))   # tuple element count
    print(f"  all-reduce carrying {n_fused} fused reduction(s): "
          f"{ops[:70]}")

# Rough replication check: does any (G, p, W)-sized buffer appear
# unsharded in the module's parameter/result layout?
full = re.findall(rf"f32\[{G},{p},{W}\]", hlo)
print(f"full-size f32[{G},{p},{W}] buffers in HLO: {len(full)} "
      "(0 = never replicated)")
