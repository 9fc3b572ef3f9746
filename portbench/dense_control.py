#!/usr/bin/env python3
"""The control of the dense cell at the cell's own size, on the given
seeds (not run by the benchmark's runs):

    python3 portbench/dense_control.py --workload map_hashes.chr13_dense \
        --seeds 1,2,3

Prints one JSON line a seed with the control's readings, under the names
of the run's checks; one at least must read above its limit of 0."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.lib import dense_control  # noqa: E402

if __name__ == "__main__":
    sys.exit(dense_control.main())
