"""The multi-card path at a CPU size: the training cell on more than one
card run as two ranks (gloo, one process each; rank 0 this test's own
process, rank 1 started by the harness as ``rank.py``).  A sound run is
judged correct against the reference over the global batch, each fault
the cell can have (the training faults, and on more than one card the
gradient sum left out on a rank and BatchNorm kept local to a rank)
makes `correct` false through a number the sound run passes, and the
control (the reference in float8 in the program's place) fails the
limits."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

import faults
import harness
import readings
from test_portbench_manifest import _check_entries
from tiny import tiny_cell

SEED = 2 ** 31 + 77
WORKLOAD = "prn50-train-dp4"

# The four-card cell's entries, which BENCHMARK.json does not list yet
# (PERF.md, Open questions); its files are under portbench/.
DP4 = {
    "workload": {"name": WORKLOAD, "config": "prn50-panoptic", "traffic": "train-dp4-b2",
                 "chips": 4, "why": "one _train call on 4 cards, batch 2 x 31 views a rank (248 "
                 "crops a step), 256 cached frames: NCCL gradient sum, global BatchNorm, sharded "
                 "loaders"},
    "metrics": ["train_frames_per_s", "loader_frames_per_s.train", "train_step_ms.train",
                "mfu.train", "device_idle.train", "step_host_ms.train", "loader_wait_ms.train",
                "log_point_s.train", "host_waits.train"],
    "per_layer": [{"name": "nccl_ms.train", "unit": "ms", "better": "lower",
                   "source": "device_trace", "layer": "collectives",
                   "moves": "train_frames_per_s"}],
}


def dp4_manifest():
    """BENCHMARK.json with the four-card cell's entries added."""
    manifest = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    if WORKLOAD in {w["name"] for w in manifest["workloads"]}:
        return manifest
    manifest["workloads"].append(dict(DP4["workload"]))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in DP4["metrics"]:
            m["workloads"].append(WORKLOAD)
    manifest["per_layer"] += [dict(m, workloads=[WORKLOAD]) for m in DP4["per_layer"]]
    return manifest


def test_the_four_card_entries_fit_the_manifest():
    """The entries keep the manifest's format and its four-card share, and
    the cell's files are found by name."""
    manifest = dp4_manifest()
    _check_entries(manifest)
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(manifest["workloads"]) // 4)
    cell = harness.Cell(manifest, WORKLOAD)
    assert cell.workload["chips"] == 4 and callable(cell.kind().run)
    assert {m["name"] for m in cell.end_to_end} == {"train_frames_per_s", "setup_s"}
    for m in cell.per_layer:
        assert harness.metric_reader(m["name"]) is not None


def _run(fault=None):
    cell, overrides = tiny_cell(WORKLOAD, manifest=dp4_manifest())
    planted = faults.Faults([fault]) if fault else None
    try:
        return harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(), overrides,
                                planted)
    finally:
        harness.stop_child_processes()


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_two_ranks_train_correct_and_count_every_rank(sound):
    assert sound["correct"], sound["checks"]
    assert sound["device"]["count"] == 2
    assert sound["diagnostics"]["ranks"] == {"codes": [0], "killed": []}
    window = sound["diagnostics"]["window"]
    assert window["frames"] == window["steps"] * 2 * 2  # B 2 a rank, 2 ranks
    from multi_view_active_learning_tpu_torch import parallel

    assert not parallel.active()  # rank 0 left the group


@pytest.mark.parametrize("fault", faults.KINDS["train"] + faults.RANKS)
def test_fault_is_caught(fault, sound):
    result = _run(fault)
    assert not result["correct"]
    caught = [name for name, c in result["checks"].items()
              if (c["value"] is None or c["value"] > c["limit"])
              and sound["checks"][name]["value"] <= c["limit"]]
    assert caught, (result["checks"], sound["checks"])


def test_control_fails_the_limits():
    cell, overrides = tiny_cell(WORKLOAD, manifest=dp4_manifest())
    try:
        out = readings.read_seed(cell, SEED, 0.2, "cpu", True, None, overrides)
    finally:
        harness.stop_child_processes()
    assert all(v <= cell.limits["limits"][k] for k, v in out["program"].items()
               if k in cell.limits["limits"]), out["program"]
    judged = harness.judge(out["control"], cell.limits["limits"])
    assert any(c["value"] is not None and c["value"] > c["limit"] for c in judged.values()), judged


def test_ranks_that_outlive_the_run_are_killed_and_reported(tmp_path):
    sleeper = tmp_path / "sleeper.py"
    sleeper.write_text("import time\ntime.sleep(600)\n")
    shared = {"world": 3, "port": harness.free_port()}
    ranks = harness.Ranks(shared, str(tmp_path / "shared.json"), script=str(sleeper))
    assert json.loads((tmp_path / "shared.json").read_text()) == shared
    codes, killed = ranks.end(timeout_s=1.0)
    assert sorted(killed) == sorted(p.pid for p in ranks.procs)
    assert codes == [-9, -9]


@pytest.mark.parametrize("loaded", [None, "flax", "jax"])
def test_a_rank_that_loaded_a_forbidden_module_exits_non_zero(loaded, tmp_path):
    """Rank 1's own look at its modules once its run is over (a process of
    its own, whose run here only loads `loaded`): a forbidden one gives
    code 4 and is named; `Ranks` then ends rank 0's run."""
    cell, overrides = tiny_cell(WORKLOAD, manifest=dp4_manifest())
    shared = {"cell": cell.saved(), "seed": SEED, "seconds": 0.2, "trace": False,
              "device": "cpu", "overrides": overrides,
              "plan": {"traced_window": False, "probes": False}}
    path = tmp_path / "shared.json"
    path.write_text(json.dumps(shared))
    script = textwrap.dedent("""
        import sys, time, types
        sys.path.insert(0, %r)
        import harness

        def follow(ctx, cell):
            if %r:
                sys.modules[%r] = types.ModuleType(%r)

        harness._watch_parent = lambda: None
        harness.Context.follow = follow
        sys.exit(harness.follow_main(%r, 1, time.perf_counter()))
    """ % (harness.HERE, loaded, loaded, loaded, str(path)))
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    if loaded:
        assert done.returncode == 4, done.stderr
        assert "forbidden modules loaded in rank 1: ['%s']" % loaded in done.stderr
    else:
        assert done.returncode == 0 and "forbidden" not in done.stderr, done.stderr


def test_a_rank_that_fails_ends_the_run(tmp_path):
    """A rank ending with another code than 0 ends rank 0 at once, with no
    result (rank 0 would otherwise wait in a collective)."""
    failing = tmp_path / "failing.py"
    failing.write_text("import sys\nsys.exit(4)\n")
    script = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, %r)
        import harness
        harness.Ranks({"world": 2, "port": 1}, %r, script=%r)
        time.sleep(60)
        print("not ended")
    """ % (harness.HERE, str(tmp_path / "shared.json"), str(failing)))
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=60)
    assert done.returncode == 5 and "not ended" not in done.stdout
    assert "rank 1 ended with code 4" in done.stderr
