from degnorm_jax.core.linalg import masked_rank_one  # noqa: F401
from degnorm_jax.core.nmf import nmf_masked, ratio_svd_rowsums  # noqa: F401
