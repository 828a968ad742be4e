"""A traced run of a PilotNet cell of the benchmark with the port's spans and
tallies recorded over the traced window, and the device's idle time put
down to them.

    python3 profile_training.py --workload pilotnet-train-x3-b1024 --seed <n> --seconds <s>

Runs the cell as ``gpubench/run.py --trace 1`` does (the same traffic, data,
warm-up, window, checks and result line), with the cell's device trace
replaced by ``gpubench.idle.RecordingTrace``, which installs
``utils.profiling.recording`` from the trace's start to its stop. The result
line gains one key, ``program_spans`` (``gpubench.idle.attribution``):

- ``train_idle_batch_share``, ``train_idle_epoch_end_share``,
  ``train_idle_other_share`` (%): the device's idle time under
  ``train.batch``, under ``train.epoch_end`` (its children in), and the rest
  (step dispatch, ``search.setup``, the last saves, no span), over the
  window; the three sum to ``train_device_idle_share``;
- ``train_host_batch_ms_per_step``: the ``train.batch`` spans' ms over
  ``train.steps``;
- ``train_h2d_gb_per_s``: ``train.h2d_bytes`` over the device seconds of
  the window's ``Memcpy HtoD`` operations;
- the idle ms under each span name, every tally, each stage's count, summed
  ms and self ms (its children's time left out), and the ten longest idle
  gaps named by the program span that covers most of each.

Needs as many CUDA cards as the cell, as the benchmark does.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from gpubench import harness, idle  # noqa: E402
from gpubench.drivers import pilotnet  # noqa: E402


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    chips = harness.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"profile_training: {args.workload} needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    pilotnet.DeviceTrace = idle.RecordingTrace
    outcome = harness.execute(args.workload, args.seed, args.seconds, True, "cuda", T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"profile_training: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line = harness.result_line(outcome, True, info)
    line["program_spans"] = idle.attribution(idle.RecordingTrace.last)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
