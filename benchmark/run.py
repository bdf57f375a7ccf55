"""The benchmark's entry: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout.
See ``benchmark/harness.py``."""

import time

T0 = time.perf_counter()  # the set-up time counts from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program at a fixed place inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, ".bench_cache", "torch_extensions"))
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
