"""The benchmark of pilotguru_tpu_torch on one H100.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as one JSON line, last on standard output, with the
numbers it compared beside their limits as the last lines on standard error.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpubench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
