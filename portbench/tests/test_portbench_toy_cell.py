"""A new architecture's bfloat16 scoring cell added as files alone: a copy
of the benchmark gains a topology (``reference/arch_toyvit.py``), a
configuration, a traffic mix, limits and manifest entries, and no other
file of it changes; the cell then runs to `correct` on the CPU, with the
toy transformer in the program's Engine (tests/toy/program_toyvit.py),
and its control, the reference in float8 e4m3, fails the limits."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import harness

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")
WORKLOAD = "toyvit-sweep-bf16"
NEW = {"reference/arch_toyvit.py": "arch_toyvit.py",
       "configs/toyvit-synthetic.json": "toyvit-synthetic.json",
       "traffic/sweep-bf16-toy.json": "sweep-bf16-toy.json",
       "limits/%s.json" % WORKLOAD: "toyvit-sweep-bf16.json"}


def _digests(base):
    out = {}
    for dirpath, dirnames, names in os.walk(base):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "tests")]
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, base)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_bf16_transformer_cell_added_as_files_runs_correct(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(harness.HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests", ".pytest_cache"))
    for dest, src in NEW.items():
        shutil.copy(os.path.join(TOY, src), copy / "portbench" / dest)
    manifest = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    manifest["configs"].append({"name": "toyvit-synthetic",
                                "source": "https://arxiv.org/abs/2204.12484",
                                "file": "portbench/configs/toyvit-synthetic.json", "reduced": [],
                                "why": "a test fixture: a two-block toy transformer in bf16"})
    manifest["workloads"].append({"name": WORKLOAD, "config": "toyvit-synthetic",
                                  "traffic": "sweep-bf16-toy", "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "sweep_frames_per_s":
            m["workloads"].append(WORKLOAD)
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))

    before, after = _digests(harness.HERE), _digests(str(copy / "portbench"))
    assert set(after) - set(before) == set(NEW)
    assert all(after[path] == digest for path, digest in before.items())

    done = subprocess.run([sys.executable, os.path.join(TOY, "drive.py"), str(copy), harness.ROOT,
                           WORKLOAD, str(2 ** 31 + 55)], capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["harness"].startswith(str(copy))
    assert out["topology_file"].startswith(str(copy / "portbench" / "reference"))
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in out["judged_control"].values()), out["judged_control"]
