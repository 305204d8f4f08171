"""A cell cut to a size the CPU runs in seconds, for the tests: 4 views of
64 x 64 crops, a handful of frames, no decode workers, at most two ranks.  Only the tests use
it; the benchmark's cells run at their files' sizes."""

import os

import harness


def tiny_cell(name: str, base: str = harness.HERE, root: str = harness.ROOT, manifest=None):
    """(cell, program overrides); `manifest` in place of `root`'s BENCHMARK.json."""
    if manifest is None:
        manifest = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = harness.Cell(manifest, name, root, base)
    cell.config["data"].update(views=4, image_size=64)
    # A multi-card cell runs two ranks here (gloo, one process each).
    cell.workload = dict(cell.workload, chips=min(int(cell.workload["chips"]), 2))
    overrides = {"DATA": {"INPUT_WIDTH": 64, "INPUT_HEIGHT": 64}}
    if cell.traffic["kind"] == "sweep":
        cell.traffic.update(pool_frames=6, sampled_batches=2, probe_steps=1)
        overrides["AL"] = {"INFERENCE": {"BATCH_SIZE": 2, "NUM_WORKERS": 0}}
    else:
        cell.traffic.update(train_frames=8, val_frames=2, probe_steps=1, min_steps=2)
        overrides["TRAIN"] = {"NUM_WORKERS": 0}
    return cell, overrides
