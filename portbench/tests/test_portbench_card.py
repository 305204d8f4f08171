"""Each cell at its full size on its CUDA cards, judged correct.  Skips
without them."""

import os
import time

import pytest

import harness

MANIFEST = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_is_correct_on_the_card(workload, cuda_device):
    import torch

    cell = harness.Cell(MANIFEST, workload)
    if torch.cuda.device_count() < int(cell.workload["chips"]):
        pytest.skip("the cell needs %d cards" % cell.workload["chips"])
    try:
        result = harness.run_cell(cell, 2 ** 31 + 101, 5.0, False, cuda_device,
                                  time.perf_counter())
    finally:
        harness.stop_child_processes()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
