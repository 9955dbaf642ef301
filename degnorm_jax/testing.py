"""``degnorm-jax-test`` console entry: run the package test suite
(the reference's ``degnorm_test`` equivalent, tests/__test__.py:23-35)."""
from __future__ import annotations

import os
import subprocess
import sys


def main() -> int:
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tests = os.path.join(repo_root, "tests")
    if not os.path.isdir(tests):
        print("tests/ directory not found next to the package", file=sys.stderr)
        return 2
    return subprocess.call([sys.executable, "-m", "pytest", tests, "-x", "-q"])


if __name__ == "__main__":
    sys.exit(main())
