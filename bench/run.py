"""Run one cell of ``BENCHMARK.json`` once, from the checkout's root:

    python3 bench/run.py --workload kron-solve --seed 7 --seconds 10 --trace 0

Prints the compared numbers beside their limits as the last lines of
standard error and one JSON result as the last line of standard output.
Exits non-zero, with no result, without the CUDA cards the cell asks
for, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# a library that would load JAX by itself is kept from doing so
os.environ.setdefault("USE_FLAX", "0")

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
