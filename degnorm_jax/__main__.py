"""``python -m degnorm_jax`` — same entry as the ``degnorm-jax`` console
script (reference degnorm/__main__.py:16)."""
import sys

from degnorm_jax.cli import main

if __name__ == "__main__":
    sys.exit(main())
