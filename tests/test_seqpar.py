"""Sequence-parallel (column-sharded) engine path on the 8-device mesh."""
import numpy as np

from degnorm_jax.parallel.sharded import make_mesh
from tests.conftest import random_coverage


def test_engine_routes_long_genes_to_column_sharding():
    """A gene longer than EngineConfig.seqpar_width lands in an ad-hoc wide
    bucket that the engine shards over the POSITION axis (sequence
    parallel); results must match the single-device engine (f64: exact up
    to reduction-order noise)."""
    from collections import OrderedDict
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine

    rng = np.random.default_rng(5)
    cov = OrderedDict()
    for i, L in enumerate((900, 1400, 700)):
        cov[f"g{i}"] = random_coverage(rng, 4, L)
    cov["glong"] = random_coverage(rng, 4, 40_000, degraded=True)
    X = np.round(np.abs(rng.standard_normal((4, 4))) * 200 + 50)

    nmf_cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)
    cfg = EngineConfig(seqpar_width=32768, dtype="float64",
                       use_pallas=False)
    r1 = DegNormEngine(nmf_cfg, cfg).run(cov, X.copy())
    mesh = make_mesh()
    eng2 = DegNormEngine(nmf_cfg, cfg, mesh=mesh)
    r2 = eng2.run(cov, X.copy())
    # the outlier bucket is wider than seqpar_width and column-sharded
    wide = [b for b in eng2._buckets if b.width >= cfg.seqpar_width]
    assert len(wide) == 1
    np.testing.assert_allclose(r2.rho, r1.rho, rtol=1e-9)
    np.testing.assert_allclose(r2.x_adj, r1.x_adj, rtol=1e-9)
