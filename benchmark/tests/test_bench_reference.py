"""The plain references against the port's train steps at toy sizes on the
CPU, through the harness's own run."""

import importlib

import pytest
import torch

from benchmark.harness import build, run
from benchmark.tests.toy import LIMITS, toy_cell

CELLS = ["clip-s1-b24", "vlm-ft-mrg-b24", "vlm-ft-vqa-int8-b24"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_train_step(name):
    cell = toy_cell(name)
    result = run(name, 2**31 + 12345, 0.2, False, device="cpu", cell=cell)
    assert result["correct"], result["checks"]
    for number, check in result["checks"].items():
        assert check["value"] < 0.1 * LIMITS[number]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"train_samples_per_s", "peak_mem_gb", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_reference_names_every_leaf_of_the_program(name):
    cell = toy_cell(name)
    program, feed = build(cell, 3, "cpu")
    feed.close()
    reference = importlib.import_module(f"benchmark.reference.{cell.config['family']}")
    table = reference.table(cell.config)
    leaves = dict(program.model.named_parameters())
    if cell.traffic.get("int8_base"):  # the frozen projections are int8 codes
        codes = {n[:-len("_q")]: b for n, b in program.model.named_buffers()
                 if n.endswith(".weight_q")}
        assert codes and all(b.dtype == torch.int8 for b in codes.values())
        leaves.update(codes)
    assert set(leaves) == set(table)
    for n, p in leaves.items():
        assert tuple(p.shape) == tuple(table[n]), n
    assert set(program.trainable()) == {n for n in table if reference.trainable(n)}


def test_traced_run_reads_every_per_layer_metric_it_can_on_the_cpu():
    result = run("clip-s1-b24", 77, 0.2, True, device="cpu", cell=toy_cell("clip-s1-b24"))
    assert result["correct"]
    metrics = result["metrics"]
    # no device on the CPU: no kernel to read, so no roofline and no step events
    assert "flash_roofline.train" not in metrics
    assert metrics["launches_per_step.train"]["value"] == 0
    assert metrics["mfu.train"]["value"] > 0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_checked_steps_run_without_dropout_and_the_window_with_it():
    cell = toy_cell("vlm-ft-mrg-b24")
    program, feed = build(cell, 5, "cpu")
    feed.close()
    rates = program.dropout_rates()
    assert {attr for _, attr, _ in rates} == {"lora", "dropout_rate"}
    with program.dropout_off():
        assert not program.has_dropout
    assert program.dropout_rates() == rates


def test_the_same_seed_gives_the_same_batches_and_weights():
    cell = toy_cell("vlm-ft-mrg-b24")
    firsts = []
    for _ in range(2):
        program, feed = build(cell, 991, "cpu")
        next(feed)
        firsts.append((feed.kept[0]["input_ids"].copy(),
                       next(iter(program.trainable().values())).detach().clone()))
        feed.close()
    assert (firsts[0][0] == firsts[1][0]).all()
    assert torch.equal(firsts[0][1], firsts[1][1])
