"""The readings the check's limits are set from, for one cell, over many
seeds in one process (no measured window: training's readings need none).

    python -m benchmark.calibrate --workload vlm-ft-mrg-b24 \
        --seeds 11,12,13 --control 3 --faults half_batch,loss_scaled

For each seed: the program's first steps as a run drives them (the lower
reading of each number against the float32 reference), and for the first
`--control` seeds also the same with each named fault planted in the
program and the control: the reference computed in fp8 and put in the
program's place (the upper readings). One JSON line per seed, then the
largest lower and the smallest upper reading of each number.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import time

import torch

from benchmark import check
from benchmark.harness import build, checked_steps, find_cell


def program_readings(cell, seed: int, device, fault=None):
    program, feed = build(cell, seed, device, fault)
    try:
        return checked_steps(program, feed), feed.kept
    finally:
        feed.close()
        program.close()
        gc.collect()
        torch.cuda.empty_cache()


def worst_leaves(got, want, k: int = 3) -> dict:
    """The `k` leaves with the largest gaps of the first gradient and of the
    change, each with its gap and its reference norm."""
    out = {}
    for key, names in (("first_grad", list(want.first_grad)),
                       ("change", check.moving_leaves(want))):
        mine, theirs = getattr(got, key), getattr(want, key)
        gaps = check.leaf_gaps(mine, theirs, names)
        top = sorted(zip(gaps, names), reverse=True)[:k]
        out[key] = [[n, g, theirs[n]] for g, n in top]
    return out


def seed_readings(cell, seed: int, device, control: bool, faults=()) -> dict:
    reference = importlib.import_module(
        f"benchmark.reference.{cell.config['family']}")
    seconds = {}
    t = time.perf_counter()
    mine, kept = program_readings(cell, seed, device)
    seconds["program"] = time.perf_counter() - t
    planted = {f: program_readings(cell, seed, device, f)[0]
               for f in (faults if control else ())}
    t = time.perf_counter()
    want = reference.train_readings(cell.config, cell.traffic, seed, kept, device)
    seconds["reference"] = time.perf_counter() - t
    row = {"seed": seed, "program": check.numbers(mine, want),
           "losses": want.losses, "program_losses": mine.losses,
           "worst": {"program": worst_leaves(mine, want)}}
    for fault, got in planted.items():
        row[fault] = check.numbers(got, want)
        row["worst"][fault] = worst_leaves(got, want)
    if control:
        fp8 = reference.train_readings(cell.config, cell.traffic, seed, kept,
                                       device, precision="fp8")
        row["control"] = check.numbers(fp8, want)
    row["seconds"] = seconds
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", type=int, default=3,
                   help="how many of the seeds also read the fp8 control "
                        "and the faults")
    p.add_argument("--faults", default="", help="comma-separated program faults")
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    rows = []
    for i, seed in enumerate(seeds):
        rows.append(seed_readings(cell, seed, "cuda", i < args.control, faults))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"lower": {n: max(r["program"][n] for r in rows) for n in check.NUMBERS}}
    for key in ["control", *faults]:
        got = [r[key] for r in rows if key in r]
        if got:
            summary[key] = {n: min(r[n] for r in got) for n in check.NUMBERS}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
