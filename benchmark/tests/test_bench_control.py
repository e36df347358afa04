"""The correctness check's control at a size a CPU test holds: the
reference in the program's place, in TF32 (the precision below the
configurations' float32), fails at least one of each cell's numbers
against the cell's limits; so does the half-batch fault of a training
cell, in the first steps and in the later epoch's. benchmark/control.py
reads the
same at the cells' own sizes on the card."""
import pytest
import torch

from benchmark import control
from benchmark.tests import tiny


@pytest.fixture
def bench(tmp_path):
    return tiny.make(tmp_path)


def fails(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("name", tiny.workloads("fit"))
@pytest.mark.parametrize("seed", [3, 2 ** 35 + 1])
def test_training_control_and_half_batch_fail(bench, name, seed):
    cell = tiny.cell(bench, name)
    out = control.train_readings(cell, seed, torch.device("cpu"), 0.5)
    assert fails(out["control"], cell.limits)
    assert fails(out["half_batch"], cell.limits)
    late = {k: v for k, v in out["half_batch"].items()
            if k.startswith("late_")}
    assert fails(late, cell.limits)


@pytest.mark.parametrize("name", tiny.workloads("predict"))
@pytest.mark.parametrize("seed", [3, 2 ** 35 + 1])
def test_serving_control_fails(bench, name, seed):
    cell = tiny.cell(bench, name)
    out = control.predict_readings(cell, seed, torch.device("cpu"))
    assert fails(out["control"], cell.limits)
