"""The control: the plain reference computed in fp8, put in the program's
place, must come out not correct. At toy sizes on the CPU here; at the
cell's own size on the card (marker `card`)."""

import importlib

import pytest

from benchmark import check
from benchmark.harness import find_cell
from benchmark.tests.toy import toy_cell


def control_numbers(cell, seed, device):
    from benchmark.calibrate import program_readings

    reference = importlib.import_module(f"benchmark.reference.{cell.config['family']}")
    mine, kept = program_readings(cell, seed, device)
    want = reference.train_readings(cell.config, cell.traffic, seed, kept, device)
    fp8 = reference.train_readings(cell.config, cell.traffic, seed, kept, device,
                                   precision="fp8")
    return check.numbers(mine, want), check.numbers(fp8, want)


@pytest.mark.parametrize("name", ["clip-s1-b24", "vlm-ft-mrg-b24"])
def test_the_fp8_control_fails_at_toy_size(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    cell = toy_cell(name)
    program, control = control_numbers(cell, 31, "cpu")
    assert check.verdict(program, cell.limits)[0]
    assert not check.verdict(control, cell.limits)[0], control


@pytest.mark.card
@pytest.mark.parametrize("name", ["clip-s1-b24", "vlm-ft-mrg-b24",
                                  "vlm-ft-vqa-int8-b24"])
def test_the_fp8_control_fails_at_the_cells_size(name, card):
    cell = find_cell(name)
    program, control = control_numbers(cell, 2**31 + 7, "cuda")
    assert check.verdict(program, cell.limits)[0], program
    assert not check.verdict(control, cell.limits)[0], control
