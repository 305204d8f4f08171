#!/usr/bin/env python3
"""How far the port's 2-rank CLI run drifts from the 1-process run at twice
the batch, on one CUDA card, per compute dtype.

    python3 tools/dist_agreement_torch.py [--dtypes bfloat16 float32] [--lr LR]

Builds chip_smoke.py's pool-sweep tree (64 + 8 frames x 31 views, 256^2,
19 joints) and runs its ``distributed_runs`` for each dtype: the CLI's
CORESET SAL run (PoseResNet-50, the sample config's depth cuts) in one
process at TRAIN and AL.INFERENCE batches of 4, under a NCCL group of one,
and as 2 gloo ranks on card 0 at batches of 2 (plus 2 NCCL ranks on two
cards when there are two).  Prints one JSON line per dtype: the
agreement of each ranks' run with the one-process run (sal_dict against the
sweep tolerance, the CORESET picks the greedy gaps decide, RESULTS), each
rank's median train-step ms and sweep seconds, and the card's name and
power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dist_agreement_torch: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    parser.add_argument("--lr", type=float, default=None,
                        help="TRAIN.OPTIM.LR of the runs (default: chip_smoke.py's DIST_LR)")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    tmp = tempfile.mkdtemp(prefix="dist_agreement_")
    try:
        tree = generate_panoptic_tree(os.path.join(tmp, "pool"),
                                      num_train_frames=chip_smoke.SWEEP_FRAMES,
                                      num_val_frames=chip_smoke.TRAIN_VAL_FRAMES,
                                      num_joints=chip_smoke.JOINTS, num_cameras=chip_smoke.VIEWS)
        lr = chip_smoke.DIST_LR if args.lr is None else args.lr
        for dtype in args.dtypes:
            runs, agreement = chip_smoke.distributed_runs(tree, os.path.join(tmp, dtype), dtype, lr)
            print(json.dumps({"dtype": dtype, "lr": lr, "card": smi, "agreement": agreement,
                              "timing": {name: chip_smoke._timing(run) for name, run in runs.items()},
                              "wall_s": {name: run["wall_s"] for name, run in runs.items()}}),
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        left = chip_smoke.stop_child_processes()
    return 1 if left else 0


if __name__ == "__main__":
    sys.exit(main())
