"""The port, chip_smoke.py and its tools (every ``tools/*_torch.py``)
import nothing of JAX or the JAX package.

An AST scan covers every import statement; a subprocess runs the port's
CPU path (the engine's steps, a 2-frame pool sweep with a decode worker,
a 2-step training run with its evaluation, checkpoints and metrics
records, then a resume from its checkpoint, and the CLI on a 2-frame SAL
experiment with ``--device cpu`` and RandAugment on, and a serving
artifact exported, saved, loaded and called) with an import hook
that refuses the banned modules, and checks that none of them was
loaded.  The modules that run under a process group (parallel/, the
engine's collectives, the strategy's gathers, the rank-0 writes in
utils/checkpoint.py and utils/metrics_writer.py) are in the scan; the rank
processes of a 2-process CLI run refuse the same modules in
tests/test_torch_distributed.py."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multi_view_active_learning_tpu_torch")
BANNED = {"jax", "jaxlib", "flax", "optax", "multi_view_active_learning_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "tools", "*_torch.py"))
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
                 "data/synthetic", "data/native", "data/pipeline", "models/layers",
                 "utils/checkpoint", "utils/evaluation", "utils/metrics_writer",
                 "utils/visualization", "utils/profiling", "workflow", "parallel/__init__",
                 "data/augmentation", "serving", "kernels/ops", "data/prep"):
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
    torch.set_num_threads(2)  # the suite's parallel workers share the host
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
    import os
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
        # Training: two steps with a log point each, then a resume.
        from multi_view_active_learning_tpu_torch.utils import metrics_writer
        metrics_writer._try_tb = lambda log_dir: None  # the JSONL record is enough here
        cfg.TRAIN.BATCH_SIZE = 1
        cfg.TRAIN.NUM_WORKERS = 0
        cfg.TRAIN.LOG_EVERY_ITER = 1
        cfg.TRAIN.OPTIM.TOTAL_STEPS = 2
        cfg.TRAIN.VAL_SIZE = 1
        state = strategy.run_fully_supervised_training(
            strategy.new_state(), build_dataset(cfg, "train"), build_dataset(cfg, "val"))
        assert int(state.step) == 2
        cfg.TRAIN.RESTORE_FROM = os.path.join(
            tmp, cfg.EXPR_NAME, "FULLY_SUPERVISED", "checkpoints", "CKPT-FINAL")
        cfg.TRAIN.OPTIM.TOTAL_STEPS = 3
        state = strategy.run_fully_supervised_training(
            strategy.new_state(), build_dataset(cfg, "train"), build_dataset(cfg, "val"))
        assert int(state.step) == 3
        # The CLI: SAL over 2 frames, 2 iterations and AL_EVAL, on the CPU.
        import json
        from multi_view_active_learning_tpu_torch import workflow
        path = os.path.join(tmp, "sal.yaml")
        with open(path, "w") as f:
            f.write("\\n".join([
                "EXPR_TYPE: SAL", "LOG_DIR: " + os.path.join(tmp, "cli"),
                "RESULTS: " + os.path.join(tmp, "results.json"),
                "AL: {STRATEGY: TRIANGULATION, INITIAL_AMOUNT: 1, ITER_AMOUNT: 1, ITERATIONS: 2,"
                " INFERENCE: {NUM_WORKERS: 0}}",
                "SAL: {NUM_FRAMES: [0, 1], INLIER_THRESHOLD: 0}",
                "TRAIN: {BATCH_SIZE: 1, VAL_SIZE: 1, NUM_WORKERS: 0, LOG_EVERY_ITER: 1,"
                " OPTIM: {TOTAL_STEPS: 1}}",
                "POSE_ESTIMATOR: {NUM_LAYERS: 18}",
                "DATA: {TYPE: synthetic, SYNTHETIC_ROOT: %%s, NUM_JOINTS: 3, INPUT_WIDTH: 32,"
                " INPUT_HEIGHT: 32, EPOCH_SIZE: 1, NUM_AUG: 1, AUG_MAGNITUDE: 9}"
                %% cfg.DATA.SYNTHETIC_ROOT,
                "TPU: {COMPUTE_DTYPE: float32, INT8_SCORING: false}", ""]))
        out = workflow.main(["--config_file", path, "--device", "cpu"])
        assert out.sizes == [1, 2], out.sizes
        with open(os.path.join(tmp, "results.json")) as f:
            assert sorted(json.load(f)) == ["1", "2"]
        # A serving artifact: exported, saved, loaded and called.
        from multi_view_active_learning_tpu_torch import serving
        engine.cfg.DATA.INPUT_HEIGHT = engine.cfg.DATA.INPUT_WIDTH = 32  # the frames' size
        path = serving.save_serving(serving.export_serving(engine, None, 1, 3),
                                    os.path.join(tmp, "model" + serving.SERVING_SUFFIX))
        box = np.tile(np.asarray([0, 0, 32, 32], np.float32), (1, 3, 1))
        served = serving.load_serving(path, device="cpu")(images, box)
        assert served["keypoints"].shape == (1, 3, 3, 2), served["keypoints"].shape
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
