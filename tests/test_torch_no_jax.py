"""The port, chip_smoke.py and tools/profile_scoring_torch.py import nothing
of JAX or the JAX package.

An AST scan covers every import statement; a subprocess runs the port's
CPU path (the engine's steps, and a 2-frame pool sweep with a decode
worker) with an import hook that refuses the banned modules, and checks
that none of them was loaded."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multi_view_active_learning_tpu_torch")
BANNED = {"jax", "jaxlib", "flax", "optax", "multi_view_active_learning_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_scoring_torch.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_the_expected_modules():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for name in ("config", "engine", "device", "ops/geometry", "ops/heatmap",
                 "ops/triangulate", "ops/coreset", "ops/uncertainty", "models/pose_resnet",
                 "models/hrnet", "models/convert", "models/quantize", "ops/int8",
                 "kernels/decode", "kernels/pairwise", "kernels/deconv", "kernels/_build",
                 "strategy", "utils/__init__", "utils/storage", "utils/prng", "utils/kmeans",
                 "ops/image", "data/__init__", "data/pools", "data/panoptic", "data/ih26m",
                 "data/synthetic", "data/native", "data/pipeline"):
        assert "multi_view_active_learning_tpu_torch/%s.py" % name in rel


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_banned_import(path):
    assert not (_imported_roots(path) & BANNED), _imported_roots(path) & BANNED


SCRIPT = textwrap.dedent(
    """
    import sys
    BANNED = %r
    already = {m for m in sys.modules if m.split(".")[0] in BANNED}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError("banned import: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, %r)
    import numpy as np
    import torch
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.engine import Engine
    from multi_view_active_learning_tpu_torch.ops import coreset

    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = 3
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.INT8_SCORING = False
    cfg.TPU.COMPUTE_DTYPE = "float32"
    engine = Engine(cfg, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(1, 3, 32, 32, 3)).astype(np.uint8)
    proj = rng.normal(size=(1, 3, 3, 4)).astype(np.float32)
    valid = np.ones((1, 3), bool)
    pairs = engine.pairs(3)
    gt = np.zeros((1, 3, 3), np.float32)
    for strategy in ("TRIANGULATION", "CORESET", "MPE", "HP", "BSB"):
        out = engine.score_step(images, proj, valid, pairs, gt, al_strategy=strategy)
        assert out["keypoints_3d"].shape == (1, 3, 3)
    engine.eval_step(images, proj, valid, pairs)
    # A narrow HRNet, int8, with direct optimization and the EMBEDDING features.
    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = 3
    cfg.POSE_ESTIMATOR.TYPE = "HRNET"
    for stage, n in ((cfg.POSE_ESTIMATOR.HRNET.STAGE2, 2), (cfg.POSE_ESTIMATOR.HRNET.STAGE3, 3),
                     (cfg.POSE_ESTIMATOR.HRNET.STAGE4, 4)):
        stage.NUM_MODULES, stage.NUM_BLOCKS = 1, [1] * n
        stage.NUM_CHANNELS = [8 * 2 ** b for b in range(n)]
    cfg.TPU.INT8_SCORING_HRNET = True
    cfg.AL.DIRECT_OPTIMIZATION = True
    hrnet = Engine(cfg, device="cpu")
    assert hrnet.use_int8
    out = hrnet.score_step(images, proj, valid, pairs, gt, int8_scales=hrnet.int8_calibrate(images))
    assert out["keypoints_3d"].shape == (1, 3, 3)
    assert hrnet.embed_step(images).shape == (1, 8)
    # The default configuration: the int8 backbone, here with K4's head.
    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = 3
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.INT8_DECONV = True
    int8 = Engine(cfg, device="cpu")
    assert int8.use_int8
    scales = int8.int8_calibrate(images)
    out = int8.score_step(images, proj, valid, pairs, gt, al_strategy="TRIANGULATION",
                          int8_scales=scales)
    assert out["keypoints_3d"].shape == (1, 3, 3)
    feats = torch.from_numpy(rng.normal(size=(20, 9)).astype(np.float32))
    labeled = torch.arange(20) >= 15
    assert coreset.k_center_greedy(feats, labeled, 4).shape == (4,)
    # A 2-frame pool sweep through FrameLoader with a decode worker.
    import shutil
    import tempfile
    from multi_view_active_learning_tpu_torch.data import build_dataset, pipeline
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy

    tmp = tempfile.mkdtemp()
    try:
        cfg = get_default_configs()
        cfg.DATA.TYPE = "synthetic"
        cfg.DATA.SYNTHETIC_ROOT = generate_panoptic_tree(
            tmp, num_train_frames=2, num_val_frames=1, num_joints=3, num_cameras=3)
        cfg.DATA.NUM_JOINTS = 3
        cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = 32
        cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
        cfg.TPU.INT8_SCORING = False
        cfg.AL.INFERENCE.NUM_WORKERS = 1
        cfg.LOG_DIR = tmp
        strategy = ActiveLearningStrategy(cfg, device="cpu")
        pool = build_dataset(cfg, "train")
        pool.resample_unlabeled_data()
        sal = strategy._compute_sal_dict(pool, None)
        assert len(sal["al_metric"]) == 2, sal
        assert not pipeline._shared_executor(1).submit(pipeline.cuda_initialized).result()
        pipeline.shutdown_shared_executors()
    finally:
        shutil.rmtree(tmp)
    loaded = {m for m in sys.modules if m.split(".")[0] in BANNED} - already
    assert not loaded, loaded
    print("NO_JAX_OK")
    """
) % (BANNED, REPO)


def test_cpu_path_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, proc.stderr[-4000:]
