from degnorm_jax.parallel.sharded import (  # noqa: F401
    make_mesh, gene_sharding, shard_bucket, sharded_iteration_step)
