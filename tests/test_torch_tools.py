"""The port's tools on the CPU, at small sizes:

  * ``tools/export_serving_torch.py --selftest``: an artifact of a fresh
    init, and an int8 artifact of a port checkpoint (``--ckpt``,
    ``--int8-calib``), which loads back equal to the serve function on the
    checkpoint's weights (the symbolic batch: tests/test_torch_serving.py);
  * ``tools/bench_serving_torch.py --device cpu`` prints one JSON line with
    tools/bench_serving.py's keys;
  * ``tools/validate_learning_torch.py --steps 2 --frames 2 --device cpu``
    runs to its MKPE line, in a process that refuses JAX and TensorBoard;
  * ``data/prep.py`` of the port against the JAX package's copy on a tiny
    raw Panoptic tree (skeleton JSONs, HD and VGA calibrations, distorted
    cameras): byte-equal labels and boxes files, through the functions and
    through the port's CLI;
  * ``tools/check_dataset_torch.py`` against ``tools/check_dataset.py`` on
    the same synthetic trees (tests/test_aux.py's pattern): the same
    report, line for line, and exit code;
  * tools/export_checkpoint.py's ``.pth`` against the port's CKPT-FINAL of
    the same weights: the port's checkpoint already carries what the JAX
    tool writes (the ``module.`` prefix, a ``num_batches_tracked`` per BN,
    the ``epoch`` / ``global_step`` / ``optimizer`` fields), so the port
    needs no export twin.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.config import get_default_configs as jax_default_configs
from multi_view_active_learning_tpu.data import prep as jax_prep
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.engine import TrainState as JaxTrainState
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.utils import checkpoint as jax_ckpt
from multi_view_active_learning_tpu_torch import serving
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data import prep
from multi_view_active_learning_tpu_torch.data.synthetic import (
    generate_ih26m_tree,
    generate_panoptic_tree,
)
from multi_view_active_learning_tpu_torch.engine import Engine
from multi_view_active_learning_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import bench_serving_torch  # noqa: E402
import check_dataset  # noqa: E402
import check_dataset_torch  # noqa: E402
import export_checkpoint  # noqa: E402
import export_serving_torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Artifacts and checkpoints hold the weights: remove each test's."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _run(main, argv):
    """(exit code, stdout) of a tool's main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _small_yaml(tmp_path):
    path = str(tmp_path / "small.yaml")
    with open(path, "w") as f:
        f.write("DATA: {INPUT_WIDTH: 32, INPUT_HEIGHT: 32}\n")
    return path


def test_export_serving_selftest_fresh_init(tmp_path):
    out = str(tmp_path / ("model" + serving.SERVING_SUFFIX))
    rc, text = _run(export_serving_torch.main, [
        "--out", out, "--config_file", _small_yaml(tmp_path), "--num_layers", "18",
        "--num_joints", "4", "--views", "2", "--batch", "2", "--selftest", "--device", "cpu"])
    assert rc == 0, text
    assert "WARNING: no --ckpt" in text and "selftest ok: heatmaps (2, 2, 8, 8, 4)" in text
    assert serving.load_serving(out, device="cpu").meta["batch"] == 2


def test_export_serving_int8_checkpoint(tmp_path):
    """--ckpt reads a port checkpoint; the int8 artifact equals the serve
    function on the checkpoint's weights with the tool's calibration."""
    cfg = get_default_configs()
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = 32
    cfg.DATA.NUM_JOINTS = 4
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.INT8_SCORING_FORCE = True
    engine = Engine(cfg, device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(3))
    for t in state.params.values():
        t.add_(0.05 * torch.randn(t.shape, generator=torch.Generator().manual_seed(4)))
    path = ckpt.save_checkpoint(str(tmp_path / "CKPT-FINAL"), state)
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 256, size=(2, 2, 32, 32, 3)).astype(np.uint8)
    np.savez(str(tmp_path / "calib.npz"), images=calib)
    out = str(tmp_path / ("model_i8" + serving.SERVING_SUFFIX))
    rc, text = _run(export_serving_torch.main, [
        "--ckpt", path, "--out", out, "--config_file", _small_yaml(tmp_path), "--num_layers",
        "18", "--num_joints", "4", "--views", "2", "--batch", "3",
        "--int8-calib", str(tmp_path / "calib.npz"), "--selftest", "--device", "cpu"])
    assert rc == 0 and "selftest ok: heatmaps (3, 2, 8, 8, 4)" in text, text
    call = serving.load_serving(out, device="cpu")
    assert call.meta["batch"] == 3 and call.meta["int8"]
    engine.use_state(state)
    ref = serving.build_serve_fn(engine, None, engine.int8_calibrate(calib))
    box = np.tile(np.asarray([0, 0, 32, 32], np.float32), (3, 2, 1))
    images = rng.integers(0, 256, size=(3, 2, 32, 32, 3)).astype(np.uint8)
    got = call(images, box)
    want = ref(torch.from_numpy(images), torch.from_numpy(box))
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-5)


def test_bench_serving_prints_one_json_line_with_jax_keys():
    rc, text = _run(bench_serving_torch.main, [
        "--device", "cpu", "--num_layers", "18", "--views", "2", "--img", "32", "--joints", "4",
        "--requests", "3", "--batches", "1,2", "--warmup_s", "0"])
    lines = text.strip().splitlines()
    assert rc == 0 and len(lines) == 1, text
    result = json.loads(lines[0])
    assert {"model", "views", "img", "int8", "latency_ms", "throughput_frames_per_sec"} <= set(result)
    assert set(result["latency_ms"]) == {"p50", "p90", "p99"}
    assert set(result["throughput_frames_per_sec"]) == {"1", "2"}
    assert result["device"] == "cpu" and result["artifact_mb"] > 1
    assert 0 < result["latency_ms"]["p50"] <= result["latency_ms"]["p99"]


VALIDATE = textwrap.dedent(
    """
    import runpy
    import sys
    BANNED = ("jax", "jaxlib", "flax", "optax", "multi_view_active_learning_tpu", "tensorboard")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError("refused import: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    torch.set_num_threads(2)
    sys.argv = ["validate_learning_torch.py"] + sys.argv[1:]
    try:
        runpy.run_path(%r, run_name="__main__")
    except SystemExit as e:
        print("EXIT", e.code)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    assert not loaded, loaded
    """
) % os.path.join(REPO, "tools", "validate_learning_torch.py")


def test_validate_learning_runs_to_its_mkpe_line(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", VALIDATE, "--steps", "2", "--frames", "2", "--device", "cpu",
         "--workdir", str(tmp_path)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "train-set MKPE:" in proc.stdout and "3D-PCK@5:" in proc.stdout, proc.stdout
    assert "VALIDATION FAILED" in proc.stdout and "EXIT 1" in proc.stdout  # 2 steps learn nothing


def _raw_panoptic_tree(root):
    """A tiny raw CMU Panoptic tree: per-frame skeleton JSONs (one without a
    body) and a calibration file with HD and VGA cameras, two poses."""
    rng = np.random.default_rng(0)
    for p, pose in enumerate(("171204_pose1", "171204_pose3")):
        skel_dir = os.path.join(root, pose, "hdPose3d_stage1_coco19")
        os.makedirs(skel_dir)
        for i in range(3):
            bodies = [] if i == 1 and p == 0 else [{
                "id": 0, "joints19": (rng.normal(size=(19, 4)) * [40, 40, 40, 0.2]
                                      + [0, -100, 0, 0.8]).reshape(-1).tolist()}]
            with open(os.path.join(skel_dir, "body3DScene_%08d.json" % (100 + 25 * i)), "w") as f:
                json.dump({"version": 0.7, "univTime": 0.0, "bodies": bodies}, f)
        cams = []
        for c in range(3):
            angle = 2 * np.pi * c / 3
            R = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]]
            cams.append({"name": "00_%02d" % c, "type": "hd", "R": R,
                         "t": [[rng.normal() * 5], [rng.normal() * 5], [300.0]],
                         "K": [[1400.0, 0, 960.0], [0, 1400.0, 540.0], [0, 0, 1]],
                         "distCoef": (rng.normal(size=5) * 0.01).tolist()})
        cams.append({"name": "01_01", "type": "vga", "R": R, "t": [[0], [0], [1]],
                     "K": [[1, 0, 0], [0, 1, 0], [0, 0, 1]], "distCoef": [0] * 5})
        with open(os.path.join(root, pose, "calibration_%s.json" % pose), "w") as f:
            json.dump({"calibDataSource": pose, "cameras": cams}, f)
    return {"train": ["171204_pose1"], "val": ["171204_pose3"]}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_prep_writes_the_jax_files_byte_for_byte(tmp_path):
    raw = str(tmp_path / "raw")
    split = _raw_panoptic_tree(raw)
    for lib, tag in ((jax_prep, "jax"), (prep, "port")):
        lib.aggregate_panoptic_labels(raw, split, str(tmp_path / ("labels_%s.json" % tag)))
        lib.compute_gt_boxes(str(tmp_path / ("labels_%s.json" % tag)),
                             str(tmp_path / ("boxes_%s.json" % tag)))
    assert _bytes(tmp_path / "labels_port.json") == _bytes(tmp_path / "labels_jax.json")
    assert _bytes(tmp_path / "boxes_port.json") == _bytes(tmp_path / "boxes_jax.json")
    labels = json.loads(_bytes(tmp_path / "labels_port.json"))
    assert sorted(labels["train"]["171204_pose1"]) == ["100", "150", "cameras"]
    assert sorted(labels["train"]["171204_pose1"]["cameras"]) == ["00_00", "00_01", "00_02"]

    # The port's CLI (python -m multi_view_active_learning_tpu_torch.data.prep).
    with open(str(tmp_path / "split.json"), "w") as f:
        json.dump(split, f)
    prep.main(["aggregate", "--raw", raw, "--split_json", str(tmp_path / "split.json"),
               "--out", str(tmp_path / "labels_cli.json")])
    prep.main(["boxes", "--labels", str(tmp_path / "labels_cli.json"),
               "--out", str(tmp_path / "boxes_cli.json")])
    assert _bytes(tmp_path / "labels_cli.json") == _bytes(tmp_path / "labels_jax.json")
    assert _bytes(tmp_path / "boxes_cli.json") == _bytes(tmp_path / "boxes_jax.json")


def _corrupt(root):
    """Drop one camera from a pose's camera dict."""
    with open(os.path.join(root, "labels.json")) as f:
        labels = json.load(f)
    pose = next(iter(labels["train"]))
    del labels["train"][pose]["cameras"][next(iter(labels["train"][pose]["cameras"]))]
    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump(labels, f)


def _tree(kind, root):
    if kind == "ih26m":
        return generate_ih26m_tree(root, num_frames=3, num_joints=42, num_cameras=3), "ih26m"
    root = generate_panoptic_tree(root, num_train_frames=3, num_val_frames=2, num_joints=5,
                                  num_cameras=2)
    if kind == "panoptic_corrupt":
        _corrupt(root)
    return root, "panoptic"


@pytest.mark.parametrize("kind,extra,rc", [
    ("panoptic", [], 0), ("panoptic_corrupt", [], 1), ("ih26m", ["--num_views", "3"], 0),
    ("panoptic", ["--build"], 0)])
def test_check_dataset_matches_the_jax_tool(tmp_path, kind, extra, rc):
    root, data_type = _tree(kind, str(tmp_path / "tree"))
    argv = ["--type", data_type, "--root", root] + extra
    reports = {}
    for name, tool in (("jax", check_dataset), ("port", check_dataset_torch)):
        old = sys.argv
        sys.argv = [name] + argv  # tools/check_dataset.py reads sys.argv
        try:
            reports[name] = _run(lambda a, tool=tool: tool.main() if tool is check_dataset
                                 else tool.main(a), argv)
        finally:
            sys.argv = old
    assert reports["port"] == reports["jax"]
    assert reports["port"][0] == rc, reports["port"][1]
    if "--build" in extra:
        assert "indexer build train: 3 frames x 2 views" in reports["port"][1]


def test_port_checkpoint_carries_what_export_checkpoint_writes(tmp_path):
    """The JAX tool's .pth and the port's CKPT-FINAL of the same weights at
    the same step: the same ``module.``-prefixed tensors, the same
    ``num_batches_tracked`` counters, and the same top-level fields; both
    strict-load into a DDP-style wrapper of the reference-named model."""
    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = 4
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = 32
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    engine = Engine(cfg, device="cpu")
    state = engine.init_state(torch.Generator().manual_seed(0))
    state.step.fill_(7)
    port_path = ckpt.save_checkpoint(str(tmp_path / "CKPT-FINAL"), state)

    jcfg = jax_default_configs()
    jcfg.DATA.NUM_JOINTS = 4
    jcfg.DATA.INPUT_WIDTH = jcfg.DATA.INPUT_HEIGHT = 32
    jcfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.INT8_SCORING = False
    params, stats = jax_convert.torch_state_dict_to_flax(
        {k: v.numpy() for k, v in state.state_dict().items()}, "POSE_RESNET")
    jengine = JaxEngine(jcfg)
    jstate = JaxTrainState(step=jnp.asarray(7, jnp.int32), params=params, batch_stats=stats,
                           opt_state=jengine.tx.init(params))
    orbax_dir = jax_ckpt.save_checkpoint(str(tmp_path / "jax" / "CKPT-FINAL"), jstate)
    export_checkpoint.export_checkpoint(jcfg, orbax_dir, str(tmp_path / "export.pth"))

    port = torch.load(port_path, weights_only=True)
    ref = torch.load(str(tmp_path / "export.pth"), weights_only=True)
    assert set(port) == set(ref) == {"epoch", "global_step", "state_dict", "optimizer"}
    assert port["global_step"] == ref["global_step"] == 7 and port["epoch"] == ref["epoch"]
    assert {"state", "param_groups"} <= set(port["optimizer"]) and set(ref["optimizer"]) == {
        "state", "param_groups"}
    assert set(port["state_dict"]) == set(ref["state_dict"])
    assert all(k.startswith("module.") for k in port["state_dict"])
    for key, value in ref["state_dict"].items():
        assert port["state_dict"][key].dtype == value.dtype, key
        assert torch.equal(port["state_dict"][key], value), key
    assert int(port["state_dict"]["module.bn1.num_batches_tracked"]) == 7

    class Wrapped(torch.nn.Module):  # the reference's DDP module's names
        def __init__(self, module):
            super().__init__()
            self.module = module

    for payload in (port, ref):
        Wrapped(engine.model.__class__(4, 18)).load_state_dict(payload["state_dict"], strict=True)
