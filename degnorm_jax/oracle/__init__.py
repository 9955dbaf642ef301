from degnorm_jax.oracle.nmfoa import (  # noqa: F401
    rank_one,
    nmf_oa,
    ratio_svd,
    high_coverage_idx,
    baseline_selection,
    degnorm_fit,
    DegNormResult,
)
