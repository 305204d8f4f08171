#!/usr/bin/env python3
"""Step and forward ms of chip_smoke.py's scoring paths from two checkouts,
in turns on one card.

    python3 tools/ab_paths_torch.py --a <checkout> --b <checkout>

Runs `phase_main_path` (PoseResNet-50 bf16 / float32) and
`phase_hrnet_path` (HRNet-W32 bf16, every AL strategy) of each checkout's
own chip_smoke.py in a fresh process, in the order A, B, B, A, and prints
one JSON line a run: bf16 step and forward ms, and (step ms, forward ms) of
each HRNet strategy.  Two versions are compared only inside one call
(the card and its host's load change between calls).  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
launches, ctx = cs.phase_main_path(dev)
cs.phase_hrnet_path(dev, ctx)
'''


def run(tree):
    out = subprocess.run([sys.executable, "-c", CHILD, tree], capture_output=True, text=True,
                         cwd=tree)
    rows = {}
    for line in out.stdout.splitlines():
        if not line.startswith('{"phase"'):
            continue
        d = json.loads(line)
        if d["phase"] == "main_path":
            rows["bf16"] = d["steps"]["bfloat16"]["step_ms"]
            rows["bf16_fwd"] = d["steps"]["bfloat16"]["forward_ms"]
        elif d["phase"] == "hrnet_path":
            for name, v in d["steps"].items():
                rows["hrnet_" + name] = (v["step_ms"], v["forward_ms"])
    return out.returncode, rows, out.stderr[-400:] if out.returncode else ""


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--a", required=True, help="the first checkout (e.g. the parent)")
    parser.add_argument("--b", required=True, help="the second checkout")
    args = parser.parse_args()
    failed = 0
    for tag in ("a", "b", "b", "a"):
        rc, rows, err = run(os.path.abspath(getattr(args, tag)))
        failed |= rc
        print(json.dumps({"tree": tag, "rc": rc, **rows}), err, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
