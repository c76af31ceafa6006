"""A run with the timed path broken underneath must come out not correct:
the step that leaves its state unchanged, half of each batch left out (the
mean over the rest), the loss altered where it is produced, the attention's
query and key gradients zeroed. The harness's look for a card is skipped
(the CPU, toy sizes); the rest of the run is the real one. No cell spans
chips, so no exchange can be left out. On the card (marker `card`), the
CLIP cell's limits fail the zeroed query and key gradients of B3 at the
cell's own size."""

import importlib

import pytest

from benchmark import check
from benchmark.harness import find_cell, run
from benchmark.program import FAULTS
from benchmark.tests.toy import toy_cell


@pytest.mark.parametrize("name", ["clip-s1-b24", "vlm-ft-mrg-b24"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct(name, fault):
    result = run(name, 4242, 0.1, False, device="cpu", cell=toy_cell(name),
                 fault=fault)
    assert result["correct"] is False
    failing = [n for n, c in result["checks"].items()
               if c["value"] is None or c["value"] > c["limit"]]
    assert failing, result["checks"]


@pytest.mark.card
def test_zeroed_query_and_key_gradients_fail_at_the_cells_size(card):
    from benchmark.calibrate import program_readings

    cell = find_cell("clip-s1-b24")
    seed = 2**31 + 11
    reference = importlib.import_module("benchmark.reference.clip")
    mine, kept = program_readings(cell, seed, "cuda", "attention_dqk_zeroed")
    want = reference.train_readings(cell.config, cell.traffic, seed, kept, "cuda")
    broken = check.numbers(mine, want)
    assert not check.verdict(broken, cell.limits)[0], broken
