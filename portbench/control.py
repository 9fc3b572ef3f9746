#!/usr/bin/env python3
"""The control of a cell at the cell's own size, on the given seeds (not
run by the benchmark's runs):

    python3 portbench/control.py --workload <name> --seeds 1,2,3

Prints one JSON line a seed with the control's readings, under the names
of the run's checks; each must read above its limit of 0."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.lib import control  # noqa: E402

if __name__ == "__main__":
    sys.exit(control.main())
