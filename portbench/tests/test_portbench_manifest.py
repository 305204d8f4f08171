"""BENCHMARK.json against its format (names, units, keys, bounds), and the harness finding
each cell's files by name."""

import json
import os
import re
import shutil

import pytest

import harness

MANIFEST = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    for path in MANIFEST["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", path) and not path.startswith("/")
        assert ".." not in path.split("/")
    named = [w for w in MANIFEST["command"] if w.endswith(".py")]
    assert all(any(w.startswith(p + "/") for p in MANIFEST["paths"]) for w in named)
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_entries():
    _check_entries(MANIFEST)


def _check_entries(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in manifest["end_to_end"]}
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.Cell(MANIFEST, workload)
    assert cell.config["name"] == cell.workload["config"]
    # Any kind with its module under kinds/ (and its `run`) is found.
    assert os.path.exists(os.path.join(harness.HERE, "kinds", cell.traffic["kind"] + ".py"))
    assert callable(cell.kind().run)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    assert set(cell.limits["limits"]) <= set(cell.limits["why"])


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tmp_path):
    """A new cell and a new per-layer metric need new files and manifest
    entries only: copy the data files, add a traffic mix, its limits, a
    reader and the entries, and the harness finds them."""
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub), base / sub)
    traffic = json.loads((base / "traffic" / "sweep-int8-b16.json").read_text())
    traffic["program"]["AL"]["INFERENCE"]["BATCH_SIZE"] = 8
    (base / "traffic" / "sweep-int8-b8.json").write_text(json.dumps(traffic))
    shutil.copy(base / "limits" / "prn50-sweep-int8-b16.json",
                base / "limits" / "prn50-sweep-int8-b8.json")
    (base / "metrics" / "sweeps_in_window.sweep.py").write_text(
        "def read(r):\n    return r.window.get('sweeps')\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "prn50-sweep-int8-b8", "config": "prn50-panoptic",
                                  "traffic": "sweep-int8-b8", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "sweeps_in_window.sweep", "unit": "sweeps",
                                  "better": "higher", "source": "host_clock", "layer": "strategy",
                                  "moves": "sweep_frames_per_s",
                                  "workloads": ["prn50-sweep-int8-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.Cell(manifest, "prn50-sweep-int8-b8", root=str(tmp_path), base=str(base))
    assert cell.traffic["program"]["AL"]["INFERENCE"]["BATCH_SIZE"] == 8
    assert "sweeps_in_window.sweep" in {m["name"] for m in cell.per_layer}
    reader = harness.metric_reader("sweeps_in_window.sweep", str(base))

    class R:
        window = {"sweeps": 3}
    assert reader(R()) == 3


def test_a_kind_added_as_a_file_is_found(tmp_path, monkeypatch):
    """A traffic kind is its module under kinds/, found by the traffic's
    ``kind``: no list of kinds names it."""
    kinds = tmp_path / "kinds"
    kinds.mkdir()
    (kinds / "__init__.py").write_text("")
    (kinds / "replay.py").write_text("def run(ctx):\n    return 'replayed'\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import importlib
    import sys

    saved = {k: v for k, v in sys.modules.items() if k == "kinds" or k.startswith("kinds.")}
    for k in saved:
        del sys.modules[k]
    try:
        cell = harness.Cell(MANIFEST, MANIFEST["workloads"][0]["name"])
        cell.traffic = dict(cell.traffic, kind="replay")
        assert cell.kind().run(None) == "replayed"
    finally:
        for k in [k for k in sys.modules if k == "kinds" or k.startswith("kinds.")]:
            del sys.modules[k]
        sys.modules.update(saved)
        importlib.invalidate_caches()


def test_multi_card_cells_ask_for_four_cards_at_most_a_quarter():
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)
