"""The port's CLI (workflow.py) against the JAX package's CLI, each through
its ``main(["--config_file", ...])`` on the same YAML and the same tiny
synthetic tree (8 + 2 frames, 3 cameras, 4 joints, 32x32 crops),
PoseResNet-18 in float32, scored and trained in batches of 2:

  * **SAL**, 2 iterations then AL_EVAL (TRIANGULATION, 2 + 2 frames, 2
    pseudo-labels): the guid logs (SAMPLED-GUID-ITER-0/1, SAL-GUID-ITER-1)
    byte-equal, after the rank gaps that decide them are asserted to exceed
    the metric tolerance; SAL-DICT-ITER-1 within tests/test_torch_strategy.py's
    tolerances (inlier counts exact, metrics rtol 1e-4 / atol 1e-3,
    keypoints atol 1e-2); RESULTS' MKPE, PCK and PCKh within atol 1e-3; the
    same ``CKPT-*`` names in each iteration (the MKPE in a name compared as a
    number, within 0.01, its printed digit); the AL writer's records, the
    same tags and steps, ``sal/*`` histograms with equal counts and
    moments within the metric tolerance.
  * **AL.START_ITER 1** from the SAL run's directory (AL.PREVIOUS_AL_LOG_DIR),
    the port's CLI only: its copied and new guid logs byte-equal to the
    JAX CLI's uninterrupted run (and the port's), ITER-0's checkpoint
    copied byte for byte, and RESULTS within atol 1e-3 of the JAX run's.
  * **SUPERVISED -> EVAL with DATA.NUM_AUG 2** (AUG_MAGNITUDE 9, random
    magnitudes): ``metrics.jsonl`` compared as
    tests/test_torch_training_loop.py compares it, and RESULTS within 1e-3.
  * **CLUSTER**: POSE's JSON equal; LOSS's per-frame losses within rtol 1e-4.
  * ``evaluate_2d_pckh`` on the val frames: the same thresholds, per-joint
    PCKh within 1e-6 (a fraction of 2 x 3 crops: equal hits).
  * Port only: the CLI needs ``--device cpu`` without a card; a
    TPU.DATA_AXIS that is not the world size raises ValueError, and
    TPU.VIEW_AXIS 2 raises NotImplementedError naming ROADMAP A9b (runs of
    more than one process: tests/test_torch_distributed.py).

Both packages start from the same weights: each one's ``new_state(salt)`` is
the port's ``init_state`` from ``RANDOM_SEED + salt``, given to JAX through
its ``torch_state_dict_to_flax``.  The JAX CLI runs on one device (its
``mesh_from_config`` gives no mesh here), as the port runs one card.  LR is
1e-9: Adam moves a weight about lr * sign(g) a step, and a near-zero
gradient's sign differs between the frameworks, so at a useful LR the
random-init heatmaps' argmaxes already flip between them within a few steps
(tests/test_torch_training_loop.py); at 1e-9 that noise is below the
forward's float noise.  Both metrics writers skip their TensorBoard mirror
(its import takes 10-15 s here; the JSONL record is what is compared).
The checkpoints' contents are dropped once the runs that read them are
done, and the module's directory at its end: the tests read checkpoint
names, and the suite's workers share one disk (ROADMAP Queue C).
"""

import hashlib
import json
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu import workflow as jax_workflow
from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.data import build_dataset as jax_build_dataset
from multi_view_active_learning_tpu.engine import TrainState as JaxTrainState
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.strategy import ActiveLearningStrategy as JaxStrategy
from multi_view_active_learning_tpu.utils import metrics_writer as jax_metrics_writer
from multi_view_active_learning_tpu_torch import parallel, workflow
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data import build_dataset
from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
from multi_view_active_learning_tpu_torch.engine import Engine
from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy
from multi_view_active_learning_tpu_torch.utils import metrics_writer

JOINTS, CAMS, TRAIN_FRAMES = 4, 3, 8
AL_FRAMES, SAL_FRAMES = 2, 2
METRIC_RTOL, METRIC_ATOL, KP_ATOL = 1e-4, 1e-3, 1e-2
RESULT_ATOL = 1e-3
EXEMPT = re.compile(r"^(steps_per_sec|perf/|hbm/)")

YAML = """
EXPR_NAME: "{name}"
EXPR_TYPE: "{expr_type}"
LOG_DIR: "{log_dir}"
RESULTS: "{log_dir}/results.json"
COMMENT: "port against JAX"
AL:
  STRATEGY: "TRIANGULATION"
  INITIAL_AMOUNT: {al}
  ITER_AMOUNT: {al}
  ITERATIONS: 2
  START_ITER: {start_iter}
  PREVIOUS_AL_LOG_DIR: "{previous}"
  INFERENCE: {{BATCH_SIZE: 2, NUM_WORKERS: 0}}
  CLUSTER: {{TYPE: "{cluster}", SAVE_PATH: "{log_dir}/cluster.json"}}
SAL: {{NUM_FRAMES: [0, {sal}], INLIER_THRESHOLD: 0}}
TRAIN:
  BATCH_SIZE: 2
  VAL_SIZE: 2
  NUM_WORKERS: 0
  LOG_EVERY_ITER: 2
  OPTIM: {{TOTAL_STEPS: {steps}, LR: 1.0e-9}}
POSE_ESTIMATOR: {{TYPE: "POSE_RESNET", NUM_LAYERS: 18}}
DATA:
  TYPE: "synthetic"
  SYNTHETIC_ROOT: "{tree}"
  NUM_JOINTS: {joints}
  INPUT_WIDTH: 32
  INPUT_HEIGHT: 32
  EPOCH_SIZE: 4
  USE_NATIVE_LOADER: false
  NUM_AUG: {num_aug}
  AUG_MAGNITUDE: 9
  USE_CONST_AUG_MAGNITUDE: false
TPU: {{COMPUTE_DTYPE: "float32", INT8_SCORING: false, DATA_AXIS: {data_axis},
      VIEW_AXIS: {view_axis}}}
"""


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's small CPU steps (the suite's
    parallel workers would otherwise oversubscribe the host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _write_cfg(tmp, tag, side, tree, **fields):
    opts = dict(name="cli", expr_type="SAL", al=AL_FRAMES, sal=SAL_FRAMES, start_iter=0,
                previous="", cluster="POSE", steps=2, num_aug=0, joints=JOINTS, tree=tree,
                data_axis=-1, view_axis=1)
    opts.update(fields)
    log_dir = os.path.join(tmp, tag, side)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(YAML.format(log_dir=log_dir, **opts))
    return path, log_dir


def _expr_dir(log_dir):
    """The run's timestamped experiment directory."""
    names = [n for n in os.listdir(log_dir) if os.path.isdir(os.path.join(log_dir, n))]
    assert len(names) == 1, names
    return os.path.join(log_dir, names[0])


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_panoptic_tree(str(tmp_path_factory.mktemp("tree")),
                                  num_train_frames=TRAIN_FRAMES, num_val_frames=2,
                                  num_joints=JOINTS, num_cameras=CAMS)


@pytest.fixture(scope="module")
def same_init(tree, tmp_path_factory):
    """Patch the JAX strategy's new_state so that it starts from the port's
    init_state weights for the same salt."""
    path, _ = _write_cfg(str(tmp_path_factory.mktemp("init")), "init", "port", tree)
    cfg = get_default_configs()
    cfg.merge_from_file(path)
    engine = Engine(cfg, "cpu")

    weights = {}  # seed -> flax (params, batch_stats): an init takes a second here

    def new_state(self, salt=0):
        seed = (int(self.al_cfg.RANDOM_SEED) + salt) & 0x7FFFFFFF
        if seed not in weights:
            sd = engine.init_state(torch.Generator().manual_seed(seed)).state_dict()
            weights[seed] = jax_convert.torch_state_dict_to_flax(
                {k: v.numpy() for k, v in sd.items()}, "POSE_RESNET")
        params, stats = weights[seed]
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                             opt_state=self.engine.tx.init(params))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxStrategy, "new_state", new_state)
        mp.setattr(jax_workflow, "mesh_from_config", lambda cfg: None)
        mp.setattr(jax_metrics_writer, "_try_tb", lambda log_dir: None)
        mp.setattr(metrics_writer, "_try_tb", lambda log_dir: None)
        yield


def _run_both(tmp, tag, tree, **fields):
    """Both CLIs on one experiment: {side: (config path, log dir, output)}."""
    out = {}
    for side in ("port", "jax"):
        path, log_dir = _write_cfg(tmp, tag, side, tree, **fields)
        if side == "port":
            result = workflow.main(["--config_file", path, "--device", "cpu"])
        else:
            result = jax_workflow.main(["--config_file", path])
        out[side] = (path, log_dir, result)
    return out


def _drop_checkpoint_contents(root):
    """Empty every checkpoint under `root` (a file, or an orbax directory),
    keeping its name."""
    for d, dirs, _ in os.walk(root):
        if os.path.basename(d) == "checkpoints":
            for name in os.listdir(d):
                path = os.path.join(d, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                    os.mkdir(path)
                else:
                    open(path, "w").close()
            dirs[:] = []


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def runs(tree, same_init, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    sal = _run_both(tmp, "sal", tree)
    # Resumed at iteration 1 from the uninterrupted run: the port only, held
    # to the JAX run that did not stop (the JAX package is the reference).
    path, log_dir = _write_cfg(tmp, "resumed", "port", tree, start_iter=1,
                               previous=_expr_dir(sal["port"][1]))
    resumed = {"port": (path, log_dir, workflow.main(["--config_file", path, "--device", "cpu"])),
               "jax": sal["jax"]}
    # The port's ITER-0 CKPT-FINAL in the uninterrupted run and as copied.
    copied = [_digest(os.path.join(_expr_dir(run["port"][1]), "ITER-0", "checkpoints",
                                   "CKPT-FINAL")) for run in (sal, resumed)]
    _drop_checkpoint_contents(tmp)
    supervised = _run_both(tmp, "supervised", tree, expr_type="SUPERVISED", steps=3, num_aug=2)
    _drop_checkpoint_contents(tmp)
    cluster = {kind: _run_both(tmp, "cluster-" + kind, tree, expr_type="CLUSTER", cluster=kind)
               for kind in ("POSE", "LOSS")}
    yield dict(sal=sal, resumed=resumed, supervised=supervised, cluster=cluster, copied=copied)
    shutil.rmtree(tmp, ignore_errors=True)


def _logs(log_dir):
    expr = _expr_dir(log_dir)
    return {name: _read(os.path.join(expr, name)) for name in sorted(os.listdir(expr))
            if "GUID" in name or name.startswith("SAL-DICT")}


def _assert_gaps(values, count, what):
    """The first `count` + 1 of `values` (in selection order) lie further
    apart than the metric tolerance, so a selection within tolerance is the
    same selection."""
    for a, b in zip(values[:count], values[1:count + 1]):
        tol = 2 * (METRIC_ATOL + METRIC_RTOL * max(abs(a), abs(b)))
        assert abs(a - b) > tol, "%s: rank gap %g within the tolerance %g" % (what, abs(a - b), tol)


def test_sal_guid_logs_are_byte_equal(runs):
    got, ref = _logs(runs["sal"]["port"][1]), _logs(runs["sal"]["jax"][1])
    assert sorted(got) == sorted(ref) == ["SAL-DICT-ITER-1", "SAL-GUID-ITER-1",
                                         "SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1"]
    sal = json.loads(got["SAL-DICT-ITER-1"])
    _assert_gaps(sorted(sal["al_metric"].values(), reverse=True), AL_FRAMES, "al_metric")
    al_set = set(json.loads(got["SAMPLED-GUID-ITER-1"]))
    cand = sorted(v for g, v in sal["sal_metric"].items() if g not in al_set)
    _assert_gaps(cand, min(2 * SAL_FRAMES, len(cand) - 1), "sal_metric")
    for name in ("SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1", "SAL-GUID-ITER-1"):
        assert got[name] == ref[name], name
    assert len(json.loads(got["SAL-GUID-ITER-1"])) == SAL_FRAMES


def _assert_sal_dict_matches(got, ref, frames):
    assert list(got) == list(ref)
    for metric in ref:
        assert list(got[metric]) == list(ref[metric]), metric
    assert len(ref["al_metric"]) == frames
    for guid in ref["al_metric"]:
        assert got["inlier_count"][guid] == ref["inlier_count"][guid], guid
        for metric in ("al_metric", "sal_metric", "mkpe"):
            assert got[metric][guid] == pytest.approx(ref[metric][guid], rel=METRIC_RTOL,
                                                      abs=METRIC_ATOL), (metric, guid)
        np.testing.assert_allclose(got["pred_3d_keypoints"][guid], ref["pred_3d_keypoints"][guid],
                                   rtol=0, atol=KP_ATOL, err_msg=guid)


def test_sal_dict_matches_jax(runs):
    got, ref = _logs(runs["sal"]["port"][1]), _logs(runs["sal"]["jax"][1])
    _assert_sal_dict_matches(json.loads(got["SAL-DICT-ITER-1"]),
                             json.loads(ref["SAL-DICT-ITER-1"]), TRAIN_FRAMES - AL_FRAMES)


def _assert_results_match(got, ref):
    assert list(got) == list(ref)
    for size in ref:
        g, r = got[size], ref[size]
        assert sorted(g) == sorted(r), size
        assert np.isfinite(g["mkpe"])
        np.testing.assert_allclose(g["mkpe"], r["mkpe"], rtol=0, atol=RESULT_ATOL)
        for key in ("thresholds", "pckh_thresholds"):
            assert list(g[key]) == list(r[key]), key
        for key in ("pcks", "pckh_pcks"):
            np.testing.assert_allclose(g[key], r[key], rtol=0, atol=RESULT_ATOL, err_msg=key)


@pytest.mark.parametrize("run", ["sal", "resumed", "supervised"])
def test_results_match_jax(runs, run):
    got = json.loads(_read(os.path.join(runs[run]["port"][1], "results.json")))
    ref = json.loads(_read(os.path.join(runs[run]["jax"][1], "results.json")))
    _assert_results_match(got, ref)
    expected = ["-1"] if run == "supervised" else [str(AL_FRAMES), str(2 * AL_FRAMES)]
    assert list(got) == expected
    out = runs[run]["port"][2]
    assert out.sizes == [int(s) for s in expected] and np.isfinite(out.avg_mkpe)


def _checkpoints(expr, sub):
    names = sorted(os.listdir(os.path.join(expr, sub, "checkpoints")))
    parsed = []
    for name in names:
        m = re.fullmatch(r"CKPT-E(\d+)-MKPE([0-9.]+|nan)", name)
        parsed.append((int(m.group(1)), float(m.group(2))) if m else (name, None))
    return parsed


@pytest.mark.parametrize("sub", ["ITER-0", "ITER-1"])
def test_sal_checkpoint_names_match_jax(runs, sub):
    got = _checkpoints(_expr_dir(runs["sal"]["port"][1]), sub)
    ref = _checkpoints(_expr_dir(runs["sal"]["jax"][1]), sub)
    assert [a for a, _ in got] == [a for a, _ in ref] == [2, "CKPT-FINAL"]
    for (_, a), (_, b) in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) <= 0.01 + 1e-9, (a, b)


def test_al_writer_records_match_jax(runs):
    got = [r for r in _jsonl(os.path.join(_expr_dir(runs["sal"]["port"][1]), "AL", "metrics.jsonl"))
           if not EXEMPT.match(r["tag"])]
    ref = [r for r in _jsonl(os.path.join(_expr_dir(runs["sal"]["jax"][1]), "AL", "metrics.jsonl"))
           if not EXEMPT.match(r["tag"])]
    assert [(r["tag"], r["step"], r.get("kind")) for r in got] == \
        [(r["tag"], r["step"], r.get("kind")) for r in ref]
    assert {"sal/mkpe", "sal/inlier_count", "sal/sal_metric", "sal/al_metric",
            "sal/al_num_frames", "sal/sal_num_frames"} <= {r["tag"] for r in got}
    for a, b in zip(got, ref):
        if b.get("kind") == "text":
            assert a["text"] == b["text"]
        elif b.get("kind") == "histogram":
            assert a["count"] == b["count"], a["tag"]
            for field in ("mean", "std", "min", "max"):
                exact = a["tag"] == "sal/inlier_count"
                assert a[field] == pytest.approx(b[field], rel=0 if exact else METRIC_RTOL,
                                                 abs=0 if exact else METRIC_ATOL), (a, b)
        else:
            assert a["value"] == b["value"], (a, b)
    # The sweep's rate is recorded too.
    tags = {r["tag"] for r in _jsonl(os.path.join(_expr_dir(runs["sal"]["port"][1]), "AL",
                                                  "metrics.jsonl"))}
    assert "perf/scoring_frames_per_sec" in tags


def test_resumed_run_replays_the_previous_iterations(runs):
    got, ref = _logs(runs["resumed"]["port"][1]), _logs(runs["sal"]["jax"][1])
    whole = _logs(runs["sal"]["port"][1])
    assert sorted(got) == sorted(ref)
    for name in ("SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1", "SAL-GUID-ITER-1"):
        assert got[name] == ref[name] == whole[name], name
    # ITER-0's checkpoint was copied, not trained again.
    expr = _expr_dir(runs["resumed"]["port"][1])
    assert os.listdir(os.path.join(expr, "ITER-0", "checkpoints")) == ["CKPT-FINAL"]
    whole_ckpt, copied_ckpt = runs["copied"]
    assert copied_ckpt == whole_ckpt


@pytest.mark.parametrize("total", [3])
def test_supervised_with_aug_metrics_match_jax(runs, total):
    records = []
    for side in ("port", "jax"):
        path = os.path.join(_expr_dir(runs["supervised"][side][1]), "FULLY_SUPERVISED", "summary",
                            "metrics.jsonl")
        records.append([r for r in _jsonl(path) if not EXEMPT.match(r["tag"])])
    got, ref = records
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in ref]
    assert {"loss/train", "lr", "3D MKPE", "3DPCK@1.0/average"} <= {r["tag"] for r in got}
    assert max(r["step"] for r in got) == total
    for a, b in zip(got, ref):
        if "value" not in b:
            assert a.get("kind") == b.get("kind"), (a, b)
        elif a["tag"] == "loss/train":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4, err_msg=a["tag"])
        elif a["tag"] == "lr":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-6, err_msg=a["tag"])
        else:
            np.testing.assert_allclose(a["value"], b["value"], atol=1e-3, err_msg=a["tag"])


def test_cluster_matches_jax(runs):
    for kind in ("POSE", "LOSS"):
        got = json.loads(_read(os.path.join(runs["cluster"][kind]["port"][1], "cluster.json")))
        ref = json.loads(_read(os.path.join(runs["cluster"][kind]["jax"][1], "cluster.json")))
        assert list(got) == list(ref) and len(got) == TRAIN_FRAMES, kind
        if kind == "POSE":
            assert got == ref
        else:
            np.testing.assert_allclose([got[g] for g in ref], [ref[g] for g in ref], rtol=1e-4)
        assert runs["cluster"][kind]["port"][2] is None


def test_evaluate_2d_pckh_matches_jax(runs):
    path = runs["sal"]["port"][0]
    cfg, jcfg = get_default_configs(), jax_configs()
    cfg.merge_from_file(path)
    jcfg.merge_from_file(path)
    port, ref = ActiveLearningStrategy(cfg, "cpu"), JaxStrategy(jcfg)
    results = []
    for strategy, build in ((port, build_dataset), (ref, jax_build_dataset)):
        pool = build(cfg if strategy is port else jcfg, "val")
        with strategy._prepare_val_dataset_for_eval(pool) as loader:
            results.append(strategy.evaluate_2d_pckh(strategy.new_state(salt=5), loader))
    (thresholds, pcks), (ref_thresholds, ref_pcks) = results
    assert list(thresholds) == list(ref_thresholds)
    np.testing.assert_allclose(pcks, ref_pcks, rtol=0, atol=1e-6)
    assert np.asarray(pcks).shape == (len(thresholds), JOINTS)


def test_cli_needs_a_device_without_a_card(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _ = _write_cfg(str(tmp_path), "nodevice", "port", tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        workflow.main(["--config_file", path])


@pytest.mark.parametrize("how", ["world_size", "view_axis"])
def test_more_than_one_process_raises_a9(tree, tmp_path, how):
    """A TPU.DATA_AXIS of 2 in a world of one process is a ValueError, as the
    JAX package's make_mesh raises for a mesh that does not match its
    devices; so is a TPU.VIEW_AXIS of 2 there (it must divide the world),
    which makes the data x view grid of four processes."""
    path, _ = _write_cfg(str(tmp_path), "a9", "port", tree,
                         data_axis=2 if how == "world_size" else -1,
                         view_axis=2 if how == "view_axis" else 1)
    if how == "world_size":
        with pytest.raises(ValueError, match="does not match 1 processes"):
            workflow.main(["--config_file", path, "--device", "cpu"])
        with pytest.raises(ValueError, match="does not match 3 processes"):
            parallel.make_mesh(2, 1, world=3)
        assert parallel.make_mesh(-1, 1, world=3) == parallel.Mesh(3, 1)
        # One process without torchrun's environment has no group to join.
        assert parallel.initialize_distributed() is False and parallel.process_index() == 0
        assert parallel.broadcast_string("k", "v") == "v"
    else:
        with pytest.raises(ValueError, match=r"view_axis \(2\) must divide the device count \(1\)"):
            workflow.main(["--config_file", path, "--device", "cpu"])
        assert parallel.make_mesh(-1, 2, world=4) == parallel.Mesh(2, 2)
        assert parallel.make_mesh(2, 2, world=4) == parallel.Mesh(2, 2)
