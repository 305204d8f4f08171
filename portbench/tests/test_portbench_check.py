"""The correctness check at a CPU size: a sound run is judged correct where
its numbers are exact, each fault the cell can have makes `correct`
false through a number the sound run passes, and the control (the
reference at the next lower precision in the program's place) fails the
cell's limits.  The harness's look for a card is skipped; the rest of a
run is driven as the command drives it."""

import time

import pytest

import faults
import harness
import readings
from tiny import tiny_cell

SEED = 2 ** 31 + 77


def _run(name, fault=None):
    cell, overrides = tiny_cell(name)
    planted = faults.Faults([fault]) if fault else None
    try:
        return harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(), overrides,
                                planted), cell
    finally:
        harness.stop_child_processes()


@pytest.fixture(scope="module")
def sound_train():
    return _run("hrnet-w32-train-b2")[0]


def test_sound_sweep_is_correct():
    result, _ = _run("prn50-sweep-int8-b16")
    assert result["correct"], result["checks"]
    assert result["checks"]["heatmap_gap"]["value"] == 0.0  # the int8 scheme emulated exactly


def test_result_line_shape():
    result, cell = _run("prn50-sweep-int8-b16")
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("fault", faults.KINDS["sweep"])
def test_sweep_fault_is_caught(fault):
    result, _ = _run("prn50-sweep-int8-b16", fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.KINDS["train"])
def test_train_fault_is_caught(fault, sound_train):
    result, _ = _run("hrnet-w32-train-b2", fault)
    assert not result["correct"]
    caught = [name for name, c in result["checks"].items()
              if (c["value"] is None or c["value"] > c["limit"])
              and sound_train["checks"][name]["value"] <= c["limit"]]
    assert caught, (result["checks"], sound_train["checks"])


@pytest.mark.parametrize("name", ["prn50-sweep-int8-b16", "hrnet-w32-train-b2"])
def test_control_fails_the_limits(name):
    cell, overrides = tiny_cell(name)
    try:
        out = readings.read_seed(cell, SEED, 0.2, "cpu", True, None, overrides)
    finally:
        harness.stop_child_processes()
    judged = harness.judge(out["control"], cell.limits["limits"])
    assert any(c["value"] is not None and c["value"] > c["limit"] for c in judged.values()), judged
