"""The readings the check's limits are set from: the program's numbers on
many seeds and the control's (the reference in TF32 in the program's
place) on some, each seed a run of the cell at its own sizes, all in one
process so that the kernels load once.  The benchmark's own runs do not
run this.

    python3 -m portbench.calibrate --workload delayed_fit.map \\
        --seconds 4 --seeds 1 2 3 --control-seeds 1 2

Prints one JSON line per seed: the program's numbers, the control's where
asked, and the run's end-to-end metrics.
"""

import argparse
import json
import sys
import time

import torch

from portbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line, run = harness.execute(args.workload, seed, args.seconds, False,
                                    time.perf_counter(),
                                    control=seed in args.control_seeds)
        print(json.dumps({
            "seed": seed,
            "program": {k: c["value"] for k, c in line["checks"].items()},
            "control": getattr(run, "control", None),
            "metrics": {k: m["value"] for k, m in line["metrics"].items()}}),
            flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
