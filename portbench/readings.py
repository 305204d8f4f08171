#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, several
seeds in one process:

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 [--seconds 5]
        [--control] [--fault half_batch] [--out readings.jsonl]

For each seed: the cell's set-up, a short window, and the numbers its
check compares, for the program as it is (the lower readings); with
``--control``, also for the control (the reference at the next lower
precision in the program's place); with ``--fault``, the program with that
fault planted (faults.py); with ``--probes``, the per-layer probes too
(``--batch`` sets another batch, for a sweep of the bare step's rate over
batch sizes).  One JSON line a seed.  A multi-card cell runs its ranks
as the benchmark does, the fault planted in rank 0.  The benchmark's own
runs never run this.  Needs the CUDA devices unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import harness  # noqa: E402
from faults import Faults  # noqa: E402


def read_seed(cell, seed: int, seconds: float, device, control: bool, fault, overrides=None,
              probes: bool = False) -> dict:
    t0 = time.perf_counter()
    faults = Faults([fault]) if fault else None
    ctx = harness.Context(cell, seed, seconds, False, device, t0, overrides, faults)
    ctx.plan = {"traced_window": False, "probes": probes}
    try:
        c = cell.kind().CELL(ctx)
        c.setup()
        e2e = c.window(seconds)
        failed = c.attempted_failed()[1]
        measured = c.probes() if probes else {}
        c.release()
        with harness.float32_reference():
            out = {"seed": seed, "fault": fault, "failed": failed, "e2e": e2e, "probes": measured,
                   "program": c.check()}
            if control:
                out["control"] = c.check(control=True)
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        ctx.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--probes", action="store_true",
                        help="also read the per-layer probes (loader alone, bare step)")
    parser.add_argument("--batch", type=int, default=0,
                        help="the scoring or training batch instead of the traffic's")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")),
                        args.workload)
    overrides = {}
    if args.batch:
        overrides = ({"AL": {"INFERENCE": {"BATCH_SIZE": args.batch}}}
                     if cell.traffic["kind"] == "sweep" else {"TRAIN": {"BATCH_SIZE": args.batch}})
    try:
        for seed in [int(s) for s in args.seeds.split(",")]:
            line = json.dumps(read_seed(cell, seed, args.seconds, args.device, args.control,
                                        args.fault, overrides, probes=args.probes))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        harness.stop_child_processes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
