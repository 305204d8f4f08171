"""The port's training loop (strategy.py: ``_train`` with ``_evaluate_all``
and the checkpoints) against the JAX package's ``_train``, on the same tiny
synthetic tree (6 + 2 frames, 3 cameras, 4 joints, 32x32 crops), PoseResNet-18
in float32, from the same initial weights (the port's ``init_state``, given
to JAX through its ``torch_state_dict_to_flax``):

  * TOTAL_STEPS 4 with LOG_EVERY_ITER 2 and VAL_SIZE 2 (log points at
    steps 2 and 4), and TOTAL_STEPS 5 (the end-of-training save at step 5);
  * ``metrics.jsonl``: the same records with the same tags and steps;
    ``loss/train`` within rtol 1e-4, ``lr`` within rtol 1e-6, ``3D MKPE``
    and the ``3DPCK`` / ``3DPCKH`` scalars within atol 1e-3 (the same
    argmax decode on heatmaps within float noise of JAX's: see the LR
    below).
    Exempt: the timing scalars (``steps_per_sec``, ``perf/*``) and device
    memory (``hbm/*``), and the image records' files;
  * the checkpoints: the same ``CKPT-E<step>-MKPE<mkpe>`` steps, the MKPE
    in the names compared as numbers (within 0.01, their printed digit),
    and ``CKPT-FINAL``.

LR is 1e-9: Adam moves a weight about lr * sign(g) a step, and a
near-zero gradient's sign differs between the frameworks, so at LR 1e-5
an argmax on the random-init heatmaps already flipped between them within
four steps; at 1e-9 that noise is below the forward's float noise.  Both writers skip their
TensorBoard mirror here (its import takes 10-15 s on this host; the JSONL
record is what is compared).
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.data import build_dataset as jax_build_dataset
from multi_view_active_learning_tpu.engine import TrainState as JaxTrainState
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.strategy import ActiveLearningStrategy as JaxStrategy
from multi_view_active_learning_tpu.utils import metrics_writer as jax_metrics_writer
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data import build_dataset
from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy
from multi_view_active_learning_tpu_torch.utils import metrics_writer

JOINTS, CAMS = 4, 3
EXEMPT = re.compile(r"^(steps_per_sec|perf/|hbm/)")



@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's many small CPU steps: under
    the suite's parallel workers, torch's default of one thread per core
    oversubscribes the host many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configure(cfg, tree, log_dir):
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = tree
    cfg.DATA.NUM_JOINTS = JOINTS
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = 32
    cfg.DATA.USE_NATIVE_LOADER = False
    cfg.DATA.EPOCH_SIZE = 12
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TRAIN.NUM_WORKERS = 0
    cfg.TRAIN.LOG_EVERY_ITER = 2
    cfg.TRAIN.VAL_SIZE = 2
    cfg.TRAIN.OPTIM.LR = 1e-9
    cfg.LOG_DIR = log_dir
    cfg.EXPR_NAME = "loop"
    return cfg


def _records(cfg, expr):
    path = os.path.join(cfg.LOG_DIR, expr, "FULLY_SUPERVISED", "summary", "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _checkpoints(cfg, expr):
    names = os.listdir(os.path.join(cfg.LOG_DIR, expr, "FULLY_SUPERVISED", "checkpoints"))
    steps = {}
    for name in names:
        m = re.fullmatch(r"CKPT-E(\d+)-MKPE([0-9.]+|nan)", name)
        if m:
            steps[int(m.group(1))] = float(m.group(2))
    return steps, "CKPT-FINAL" in names


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_metrics_writer, "_try_tb", lambda log_dir: None)
        mp.setattr(metrics_writer, "_try_tb", lambda log_dir: None)
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    tree = generate_panoptic_tree(str(tmp_path_factory.mktemp("tree")), num_train_frames=6,
                                  num_val_frames=2, num_joints=JOINTS, num_cameras=CAMS)
    logs = str(tmp_path_factory.mktemp("logs"))
    cfg = _configure(get_default_configs(), tree, os.path.join(logs, "port"))
    jcfg = _configure(jax_configs(), tree, os.path.join(logs, "jax"))
    port = ActiveLearningStrategy(cfg, device="cpu")
    jax_strategy = JaxStrategy(jcfg)
    init = port.new_state()
    params, stats = jax_convert.torch_state_dict_to_flax(
        {k: v.numpy() for k, v in init.state_dict().items()}, "POSE_RESNET")
    for total in (4, 5):
        expr = "loop%d" % total
        for strategy, c in ((port, cfg), (jax_strategy, jcfg)):
            c.EXPR_NAME = expr
            c.TRAIN.OPTIM.TOTAL_STEPS = total
        port.run_fully_supervised_training(init.clone(), build_dataset(cfg, "train"),
                                           build_dataset(cfg, "val"))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               opt_state=jax_strategy.engine.tx.init(params))
        jax_strategy.run_fully_supervised_training(jstate, jax_build_dataset(jcfg, "train"),
                                                   jax_build_dataset(jcfg, "val"))
    return cfg, jcfg


@pytest.mark.parametrize("total", [4, 5])
def test_metrics_records_match_jax(runs, total):
    cfg, jcfg = runs
    got = [r for r in _records(cfg, "loop%d" % total) if not EXEMPT.match(r["tag"])]
    ref = [r for r in _records(jcfg, "loop%d" % total) if not EXEMPT.match(r["tag"])]
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in ref]
    tags = {r["tag"] for r in got}
    assert {"loss/train", "lr", "3D MKPE", "3DPCK@1.0/average", "3DPCKH@0.5/average"} <= tags
    for a, b in zip(got, ref):
        if "value" not in b:
            assert a.get("kind") == b.get("kind"), (a, b)
            continue
        if a["tag"] == "loss/train":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4, err_msg=a["tag"])
        elif a["tag"] == "lr":
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-6, err_msg=a["tag"])
        else:
            np.testing.assert_allclose(a["value"], b["value"], atol=1e-3, err_msg=a["tag"])


@pytest.mark.parametrize("total", [4, 5])
def test_checkpoint_steps_match_jax(runs, total):
    cfg, jcfg = runs
    got, got_final = _checkpoints(cfg, "loop%d" % total)
    ref, ref_final = _checkpoints(jcfg, "loop%d" % total)
    assert sorted(got) == sorted(ref) == ([2, 4] if total == 4 else [2, 4, 5])
    assert got_final and ref_final
    for step in got:
        assert abs(got[step] - ref[step]) <= 0.01 + 1e-9, (step, got[step], ref[step])
