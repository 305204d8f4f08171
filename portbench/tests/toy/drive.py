"""Runs a cell of a copy of the benchmark on the CPU, the toy transformer
(``program_toyvit.py``) in the program's Engine in place of its pose net,
and prints the result, the control's numbers and where the harness ran
from, as one JSON line.

    python drive.py <copy root> <repo root> <workload> <seed>
"""

import json
import os
import sys
import time

copy_root, repo_root, workload, seed = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
sys.path[:0] = [os.path.join(copy_root, "portbench"), copy_root, repo_root,
                os.path.dirname(os.path.abspath(__file__))]

import harness  # noqa: E402
import readings  # noqa: E402
from multi_view_active_learning_tpu_torch import engine  # noqa: E402
from program_toyvit import ToyViT  # noqa: E402
from reference import arch  # noqa: E402

cell = harness.Cell(harness.load_json(os.path.join(copy_root, "BENCHMARK.json")), workload)
size = int(cell.config["data"]["image_size"])
engine.build_model = lambda cfg: ToyViT(cell.config["model"], size)
try:
    result = harness.run_cell(cell, seed, 0.2, False, "cpu", time.perf_counter())
    control = readings.read_seed(cell, seed, 0.2, "cpu", True, None)["control"]
finally:
    harness.stop_child_processes()
print(json.dumps({"correct": result["correct"], "checks": result["checks"],
                  "failed": result["failed"], "control": control,
                  "judged_control": harness.judge(control, cell.limits["limits"]),
                  "harness": harness.__file__, "topology": arch.topology("toyvit").__module__,
                  "topology_file": sys.modules[arch.topology("toyvit").__module__].__file__}))
