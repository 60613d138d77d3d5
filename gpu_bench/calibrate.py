"""Readings from which the limits of ``limits/<workload>.json`` are set:
the numbers that decide ``correct`` on many seeds in one process, with the
control (the plain reference in float8 in the program's place) or a
planted fault (``faults.py``) beside them.

    python3 -m gpu_bench.calibrate --workload cross.serve --seconds 4 \
        --control --seeds 2147483701 2147483702 ...
    python3 -m gpu_bench.calibrate --workload cross.train --seconds 1 \
        --fault half_batch --seeds ...

Prints one JSON line per seed: the program's numbers (or the faulted
program's), the control's where asked, the run's end-to-end metrics, and
with ``--rounding`` (training) each weight's readings against the
reference replayed in float64 (``leaf_rows`` of ``loops/train_steps.py``).
The benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from gpu_bench import harness
from gpu_bench.run import Ctx, host_settings, run_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--rounding", action="store_true",
                        help="training: also replay the reference in "
                             "float64 and print each weight's readings")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    host_settings()
    bench = harness.Bench()
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        ctx = Ctx(bench, args.workload, seed, args.seconds, False, device,
                  t0=time.perf_counter(), fault=args.fault,
                  control=args.control, rounding=args.rounding)
        outcome = run_cell(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "correct": outcome["correct"],
                          **ctx.readings, "metrics": outcome["metrics"]}),
              flush=True)
        del ctx, outcome
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
