"""Readings of a cell's compared numbers over several seeds in one process:
the program as the configuration states it (``--precision float32``), or
the control, the program with TF32 switched on for its float32 products
and convolutions (``--precision tf32``), the nearest precision below the
configuration's float32 with TF32 off; or, for a cell of the ``vo_ride``
driver, the plain extractor computed in bfloat16 put in the program's place
(``--precision bfloat16``). The limits in workloads/*.json lie between the
readings.

    python3 gpubench/control.py --workload <cell> --seconds <s> --precision tf32 --seeds 1 2 3

Prints one JSON line per seed: the numbers compared, the run's end-to-end
metrics and whether every number kept its limit. Not part of a benchmark
run.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--precision", choices=("float32", "tf32", "bfloat16"), default="tf32")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for seed in args.seeds:
        start = time.time()
        outcome = harness.execute(args.workload, seed, args.seconds, False, args.device,
                                  start, precision=args.precision)
        print(json.dumps({
            "workload": args.workload, "precision": args.precision, "seed": seed,
            "correct": all(c.ok for c in outcome.checks),
            "checks": {c.name: c.value for c in outcome.checks},
            "metrics": {k: v for k, (v, _) in outcome.end_to_end.items()},
            "notes": outcome.notes, "seconds": time.time() - start}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
