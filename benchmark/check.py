"""The comparison that decides `correct`: the program's readings of a run's
first training steps against the plain reference's, from the same weights
and the same batches.

The numbers:

  * `loss`: the largest gap of a step's loss, as a share of the
    reference's;
  * `first_grad`: the worst trained leaf's gap between the two norms of
    the first step's gradient as the optimizer got it;
  * `change`: the worst leaf's gap between the two norms of its change
    over the steps;
  * `first_grad.median`, `change.median`: the median leaf's gap of each,
    steady from seed to seed where a few small leaves carry the
    program's rounding noise (the CLIP step: see PERF.md).

A leaf's gap is |program's norm - reference's norm| over the reference's
norm of that leaf or of the median leaf, whichever is larger (some
gradients are all but zero). The change leaves out the leaves whose
reference gradient stays under `MOVING_SHARE` of the median leaf's at every
step: under Adam they move by round-off alone. A cell's
`limits/<cell>.json` names the numbers it compares, each with its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

from benchmark.reference.common import Readings

NUMBERS = ("loss", "first_grad", "change", "first_grad.median", "change.median")
MOVING_SHARE = 1e-3


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], names):
    """Each leaf's gap of norms over `names`."""
    names = list(names)
    median = statistics.median(want[n] for n in names)
    gaps = [abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def moving_leaves(reference: Readings):
    """The leaves whose reference gradient reaches `MOVING_SHARE` of the
    median leaf's at some step."""
    moving = set()
    for step in reference.grad_steps:
        floor = MOVING_SHARE * statistics.median(step.values())
        moving |= {n for n, g in step.items() if g >= floor}
    return [n for n in reference.change if n in moving]


def numbers(program: Readings, reference: Readings) -> Dict[str, float]:
    """Every number; all are infinite when the two sides do not train the
    same leaves or when a loss is not finite."""
    if set(program.first_grad) != set(reference.first_grad) or \
            len(program.losses) != len(reference.losses):
        return dict.fromkeys(NUMBERS, math.inf)
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(program.losses, reference.losses))
    grad = leaf_gaps(program.first_grad, reference.first_grad,
                     reference.first_grad)
    change = leaf_gaps(program.change, reference.change,
                       moving_leaves(reference))
    return {"loss": loss if math.isfinite(loss) else math.inf,
            "first_grad": max(grad), "change": max(change),
            "first_grad.median": statistics.median(grad),
            "change.median": statistics.median(change)}


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers `limits`
    names."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
