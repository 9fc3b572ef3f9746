#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line:

    python3 portbench/run.py --workload <traffic>.<config> --seed <n> \
        --seconds <s> --trace <0|1>

The cells, metrics and bounds are in BENCHMARK.json at the root of the
repository; portbench/lib/harness.py says how a cell finds its files."""
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's port and benchmark, before any installed copy
sys.path.insert(0, ROOT)
# kernel caches of the port's libraries, at fixed paths in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, ".portbench_cache", sub))

from portbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_process=T_PROCESS))
