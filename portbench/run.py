"""Run one cell of the benchmark once, on the card:

    python3 -m portbench.run --workload bounded_fit.vg1 --seed 7 \\
        --seconds 10 --trace 0

The last line of standard output is the result's JSON object; the lines
before it on standard error give the set-up split, the window and each
number the check compared beside its limit.  Without a CUDA device, or
with fewer cards than the cell asks for, it prints no result and exits
with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from portbench import harness

    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
