from degnorm_jax.data.buckets import GeneBucket, pack_buckets  # noqa: F401
