"""Entry point of the benchmark: one run of one cell, its result as the
last line of standard output (see `harness.py`).

    python -m benchmark.run --workload clip-s1-b24 --seed 7 --seconds 30 --trace 0

Exits with 2, printing no result, where the cell's CUDA devices are
missing or a forbidden module was loaded. The process keeps its host work
on few threads: one thread in the CPU libraries' own pools (set before
PyTorch is loaded), whose idle workers otherwise take cores from the
threads that launch the step's kernels and spread the rate from run to
run."""

from __future__ import annotations

import argparse
import os
import sys

HOST_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.update(HOST_THREADS)
    from benchmark.harness import RunError, emit, run

    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
