"""Data parallelism of the port (``parallel/``, ROADMAP A9) against the JAX
package's ``'data'`` mesh.  The port's ranks are torch processes on gloo on
the CPU, each a subprocess with torchrun's environment; the JAX reference
runs in this process on two of the suite's eight virtual CPU devices
(``parallel.make_mesh(2, 1, jax.devices()[:2])``).  A global batch of W
ranks holds rank r's rows at ``r * B ..`` (``FrameLoader.
global_batch_layout``), so where a result does not depend on the order of
its rows the in-process mesh, fed the same global batch, is the reference.

  * **Engine.** Two ranks run three PoseResNet-18 float32 64x64
    ``train_step``s, each on its half of three global batches of 4 frames x
    2 views (the second batch: one real frame on rank 0, none on rank 1),
    against JAX's ``Engine.train_step`` on the 2-device mesh over the same
    global batches, at tests/test_torch_train.py's tolerances: losses
    rtol 1e-4, skipped equal, weights within 3 * 2 * lr (lr 1e-5), and BN
    running statistics within 1e-5 after three steps at a step whose LR
    has decayed to 0, and Adam's moments after those steps within
    ``MU_TOL`` / ``NU_TOL`` of each tensor's largest moment (see there).
    The two ranks' flat buffers (weights, statistics, moments, count,
    step) are bit-equal.
  * **Row-keyed draws.** Int8 calibration (the default int8 PoseResNet-18
    engine) from the two halves equals JAX's ``int8_calibrate`` on the
    global batch: bit for bit the port's one-process table of that batch,
    and within ``INT8_RTOL`` of JAX's;
    RANDOM's draws equal ``jax.random.uniform(key, (4,))`` in rank order,
    exactly; RandAugment's rows (``device_prepare`` with DATA.NUM_AUG 2)
    equal JAX's ``device_prepare`` of the global batch within
    tests/test_torch_augmentation.py's tolerances.
  * **CLI.** ``python -m torch.distributed.run --nproc_per_node 2 -m
    multi_view_active_learning_tpu_torch.workflow --config_file ...
    --device cpu`` for SAL with CORESET, 2 iterations then AL_EVAL, against
    the JAX CLI with ``mesh_from_config`` giving the 2-device mesh (16
    frames; the training sets, 2 frames twice then 4 + 4 pseudo-labeled,
    fill whole global batches of 4: JAX's one process pads a global batch
    with copies of its last frame, each rank pads its own rows, and BN
    counts padding rows, so a padded training batch is not comparable
    there; eval and scoring batches are padded, row by row alike): guid
    logs byte-equal, after the greedy gaps and the pseudo-label rank gaps
    that decide them are asserted to exceed what the keypoints' difference
    can move; SAL-DICT and RESULTS at tests/test_torch_workflow.py's
    tolerances, SAL-DICT's keys in the global batches' order; one
    experiment directory and one stamp; checkpoints written by rank 0
    alone (each rank records the files it opens for writing: rank 1's are
    RESULTS only, which every rank writes, as in JAX); no banned module
    (jax, the JAX package) imported in either rank.
  * **Errors.** A TPU.DATA_AXIS that differs from the world size raises
    ValueError, and so does a TPU.VIEW_AXIS that does not divide it (4),
    with JAX's make_mesh messages, under two ranks; there TPU.VIEW_AXIS 2
    makes the 1 x 2 mesh (view sharding: tests/test_torch_view_sharding.py).

Both packages start from the same weights (the port's from JAX's init
through ``from_flax``; in the CLI, JAX's ``new_state`` from the port's
``init_state``, as tests/test_torch_workflow.py does).  The rank processes
start before the JAX reference runs and are read after it, so the two
overlap.
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu import parallel as jax_parallel
from multi_view_active_learning_tpu import workflow as jax_workflow
from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.data.pipeline import device_prepare as jax_device_prepare
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.engine import TrainState as JaxTrainState
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.strategy import ActiveLearningStrategy as JaxStrategy
from multi_view_active_learning_tpu import strategy as jax_strategy_mod
from multi_view_active_learning_tpu.utils import metrics_writer as jax_metrics_writer
from multi_view_active_learning_tpu_torch import parallel
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
from multi_view_active_learning_tpu_torch.engine import Engine
from multi_view_active_learning_tpu_torch.models.convert import from_flax
from multi_view_active_learning_tpu_torch.ops.heatmap import render_gaussian_heatmaps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "multi_view_active_learning_tpu")
WORLD, B, V, K, IMG, LR = 2, 2, 2, 4, 64, 1e-5
FROZEN_STEP = 3000 * 50  # LR * 0.1 ** 50 underflows to 0 in float32
AUG_IMG = 32
# Adam's moments after the three frozen steps (the weights stay put, so
# every step takes the gradient of the same weights), within this share of
# each tensor's largest |mu| (|nu|).  The random-init net's float32
# gradients keep few digits where a BN normalizes few values (layer4's 2x2
# maps) or values whose variance is below its epsilon (the deconv head;
# tests/test_torch_train.py's gradient test runs in float64 for that
# reason): the JAX package's own 1-device and 2-device runs of these steps
# differ by up to 6.1% (mu) and 2.2% (nu) of a tensor's largest moment.
# The bounds are about twice that; a gradient averaged over the ranks
# instead of summed halves mu and quarters nu.
MU_TOL, NU_TOL = 0.1, 0.05
# The CLI (tests/test_torch_workflow.py's tolerances).
JOINTS, CAMS, TRAIN_FRAMES, AL_FRAMES, SAL_FRAMES = 4, 3, 16, 2, 4
METRIC_RTOL, METRIC_ATOL, KP_ATOL, RESULT_ATOL = 1e-4, 1e-3, 1e-2, 1e-3
ROOT = 2  # joint_root_index of the Panoptic joint order
ROT_ATOL, HEAT_ATOL = 2e-3, 1e-5
# The engine's int8 calibration against JAX's, on this batch: the chain of
# bf16 activations (normalization included) rounds apart layer by layer,
# and the port's one-process table differs from JAX's by up to 2.1%
# (layer3_1/conv1), twelve of twenty scales not bit-equal.  A rank that
# kept its own half's maxima would be 25% off at the stem.
INT8_RTOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank, port, **extra):
    env = dict(os.environ, WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def _wait(procs, timeout=600):
    outs = []
    for proc in procs:
        out, _ = proc.communicate(timeout=timeout)
        outs.append(out)
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-6000:]
    return outs


# -- engine and row-keyed draws -------------------------------------------------

ENGINE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, %r)
    from multi_view_active_learning_tpu_torch import parallel
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.data.pipeline import device_prepare
    from multi_view_active_learning_tpu_torch.engine import Engine

    inputs, out_path = sys.argv[1], sys.argv[2]
    assert parallel.initialize_distributed(device="cpu")
    rank, world = parallel.process_index(), parallel.process_count()
    data = np.load(inputs)
    rows = slice(rank * %d, (rank + 1) * %d)
    init = {k[5:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("init/")}

    def configure(cfg, int8=False):
        cfg.DATA.NUM_JOINTS = %d
        cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = %d
        cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
        cfg.TRAIN.OPTIM.LR = %r
        if not int8:
            cfg.TPU.COMPUTE_DTYPE = "float32"
            cfg.TPU.INT8_SCORING = False
        return cfg

    out = {}
    engine = Engine(configure(get_default_configs()), device="cpu")
    for run, step in (("lr", 0), ("frozen", %d)):
        state = engine.state_from_state_dict(init, step=step)
        losses, skipped = [], []
        for i in range(3):
            batch = [torch.from_numpy(data["b%%d/%%s" %% (i, name)][rows])
                     for name in ("images", "gt", "pvjv", "fv")]
            state, metrics = engine.train_step(state, *batch)
            losses.append(float(metrics["loss"]))
            skipped.append(bool(metrics["skipped"]))
        out[run + "/losses"], out[run + "/skipped"] = np.array(losses), np.array(skipped)
        for kind in ("params", "buffers", "mu", "nu"):
            out[run + "/flat/" + kind] = state.flat[kind].numpy()
            for name, value in getattr(state, kind).items():
                out["%%s/%%s/%%s" %% (run, kind, name)] = value.numpy()
        out[run + "/count"] = np.array([int(state.count), int(state.step)])

    int8 = Engine(configure(get_default_configs(), int8=True), device="cpu")
    int8.load_state_dict(init)
    for name, value in int8.int8_calibrate(torch.from_numpy(data["u8"][rows])).items():
        out["scale/" + name] = value.numpy()
    scores = engine.score_step(data["u8"][rows], data["proj"][rows], data["jv"][rows],
                               engine.pairs(%d), data["kp3d"][rows], al_strategy="RANDOM",
                               key=data["key"])
    out["random"] = scores["al_metric"].numpy()
    images, heat = device_prepare(
        torch.from_numpy(data["aug_u8"][rows]), torch.from_numpy(data["aug_kp"][rows]),
        torch.from_numpy(data["aug_sigma"][rows]), data["key"], stride=4, train=True, num_aug=2,
        magnitude=9, use_rotation=True, use_image_aug=True, const_magnitude=False)
    out["aug/images"], out["aug/heat"] = images.numpy(), heat.numpy()
    np.savez(out_path, **out)
    parallel.shutdown()
    print("RANK_OK", rank)
""") % (REPO, B, B, K, IMG, LR, FROZEN_STEP, V)


def _configure(cfg, int8=False):
    cfg.DATA.NUM_JOINTS = K
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = IMG
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TRAIN.OPTIM.LR = LR
    if not int8:
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.INT8_SCORING = False
    return cfg


def _global_batches():
    """Three global batches of WORLD * B frames: the second holds one real
    frame, on rank 0 (a padded tail there, all padding on rank 1)."""
    rng = np.random.default_rng(0)
    n = WORLD * B
    out = {}
    for i, valid in enumerate(([True] * n, [True] + [False] * (n - 1), [True] * n)):
        images = rng.normal(size=(n, V, IMG, IMG, 3)).astype(np.float32)
        kp = rng.uniform(2, IMG - 2, size=(n, V, K, 2)).astype(np.float32)
        gt = render_gaussian_heatmaps(torch.from_numpy(kp / 4), IMG // 4, IMG // 4, 2.0).numpy()
        out["b%d/images" % i], out["b%d/gt" % i] = images, gt
        out["b%d/pvjv" % i] = rng.random((n, V, K)) > 0.2
        out["b%d/fv" % i] = np.asarray(valid)
    out["u8"] = rng.integers(0, 256, size=(n, V, IMG, IMG, 3)).astype(np.uint8)
    out["u8"][B:] //= 2  # the halves' activation maxima differ
    out["proj"] = rng.normal(size=(n, V, 3, 4)).astype(np.float32)
    out["jv"] = np.ones((n, K), bool)
    out["kp3d"] = np.zeros((n, K, 3), np.float32)
    out["key"] = np.asarray(jax.random.PRNGKey(5))
    out["aug_u8"] = rng.integers(0, 256, size=(n, V, AUG_IMG, AUG_IMG, 3)).astype(np.uint8)
    out["aug_kp"] = rng.uniform(0, AUG_IMG, size=(n, V, K, 2)).astype(np.float32)
    out["aug_sigma"] = rng.uniform(1.5, 2.5, size=(n,)).astype(np.float32)
    return out


def _torch_named(tree):
    """A flax parameter-shaped tree in the port's names and layouts."""
    return {k: v.numpy() for k, v in from_flax(jax.device_get(tree), {}).items()}


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """{"ranks": [rank 0's, rank 1's outputs], "jax": the references}."""
    tmp = tmp_path_factory.mktemp("engine")
    data = _global_batches()
    jengine = JaxEngine(_configure(jax_configs()))
    # On the host: train_step donates its state's buffers.
    state0 = jax.device_get(jengine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3)))
    params, stats = state0.params, state0.batch_stats
    init = {k: v.numpy() for k, v in from_flax(params, stats).items()}
    path = str(tmp / "inputs.npz")
    np.savez(path, **data, **{"init/" + k: v for k, v in init.items()})
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", ENGINE_SCRIPT, path, str(tmp / ("r%d.npz" % r))],
                              env=_rank_env(r, port), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        mesh = jax_parallel.make_mesh(WORLD, 1, jax.devices()[:WORLD])
        ref = {}
        for run, step in (("lr", 0), ("frozen", FROZEN_STEP)):
            state = jax_parallel.replicate_tree(mesh, state0.replace(
                step=np.asarray(step, state0.step.dtype)))
            losses, skipped = [], []
            for i in range(3):
                batch = (data["b%d/images" % i], np.moveaxis(data["b%d/gt" % i], 2, -1),
                         data["b%d/pvjv" % i], data["b%d/fv" % i])
                batch = [jax.device_put(a, jax_parallel.data_sharding(mesh, a.ndim)) for a in batch]
                state, metrics = jengine.train_step(state, *batch)
                losses.append(float(metrics["loss"]))
                skipped.append(bool(metrics["skipped"]))
            ref[run] = dict(losses=np.array(losses), skipped=np.array(skipped),
                            state=from_flax(*jax.device_get((state.params, state.batch_stats))),
                            mu=_torch_named(state.opt_state.mu),
                            nu=_torch_named(state.opt_state.nu),
                            count=int(state.opt_state.count), step=int(state.step))
        int8 = JaxEngine(_configure(jax_configs(), int8=True))
        assert int8.use_int8
        table = int8.int8_calibrate(params, stats, jnp.asarray(data["u8"]))
        ref["scales"] = {k: np.asarray(v) for k, v in table.items()}
        port_int8 = Engine(_configure(get_default_configs(), int8=True), device="cpu")
        port_int8.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
        one_process = {k: v.numpy() for k, v in
                       port_int8.int8_calibrate(torch.from_numpy(data["u8"])).items()}
        ref["random"] = np.asarray(jax.random.uniform(jnp.asarray(data["key"]), (WORLD * B,)))
        img, heat = jax_device_prepare(
            jnp.asarray(data["aug_u8"]), jnp.asarray(data["aug_kp"]), jnp.asarray(data["aug_sigma"]),
            jnp.asarray(data["key"]), stride=4, train=True, num_aug=2, magnitude=9,
            use_rotation=True, use_image_aug=True, const_magnitude=False)
        ref["aug"] = (np.asarray(img), np.moveaxis(np.asarray(heat), -1, 2))
    finally:
        outs = _wait(procs)
    assert all("RANK_OK" in out for out in outs), outs
    ranks = [dict(np.load(str(tmp / ("r%d.npz" % r)))) for r in range(WORLD)]
    shutil.rmtree(tmp, ignore_errors=True)  # 1.5 GB of rank outputs, read: the suite shares one disk
    return dict(ranks=ranks, jax=ref, one_process_scales=one_process)


@pytest.mark.parametrize("run", ["lr", "frozen"])
def test_ranks_hold_the_same_state(engine_runs, run):
    r0, r1 = engine_runs["ranks"]
    for kind in ("params", "buffers", "mu", "nu"):
        np.testing.assert_array_equal(r0[run + "/flat/" + kind], r1[run + "/flat/" + kind],
                                      err_msg=kind)
    np.testing.assert_array_equal(r0[run + "/count"], r1[run + "/count"])
    np.testing.assert_array_equal(r0[run + "/losses"], r1[run + "/losses"])
    np.testing.assert_array_equal(r0[run + "/skipped"], r1[run + "/skipped"])


def test_losses_and_skips_match_jax(engine_runs):
    for run in ("lr", "frozen"):
        got, ref = engine_runs["ranks"][0], engine_runs["jax"][run]
        np.testing.assert_allclose(got[run + "/losses"], ref["losses"], rtol=1e-4, err_msg=run)
        # The batch whose rank 1 holds only padding still steps.
        assert not ref["skipped"].any() and not got[run + "/skipped"].any(), run
        assert list(got[run + "/count"]) == [ref["count"], ref["step"]] == [
            3, 3 + (FROZEN_STEP if run == "frozen" else 0)]


def test_weights_match_jax(engine_runs):
    got, ref = engine_runs["ranks"][0], engine_runs["jax"]["lr"]["state"]
    names = [k[len("lr/params/"):] for k in got if k.startswith("lr/params/")]
    assert names and set(names) <= set(ref)
    for name in names:
        err = float(np.abs(got["lr/params/" + name] - ref[name].numpy()).max())
        assert err <= 3 * 2 * LR, (name, err)


def test_bn_statistics_match_jax(engine_runs):
    got, ref = engine_runs["ranks"][0], engine_runs["jax"]["frozen"]["state"]
    names = [k[len("frozen/buffers/"):] for k in got if k.startswith("frozen/buffers/")]
    assert len(names) == len([n for n in ref if "running" in n])
    worst = max(float(np.abs(got["frozen/buffers/" + n] - ref[n].numpy()).max()) for n in names)
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("moment,tol", [("mu", MU_TOL), ("nu", NU_TOL)])
def test_adam_moments_match_jax(engine_runs, moment, tol):
    got, ref = engine_runs["ranks"][0], engine_runs["jax"]["frozen"][moment]
    prefix = "frozen/%s/" % moment
    assert set(ref) == {k[len(prefix):] for k in got if k.startswith(prefix)}
    for name, value in ref.items():
        scale = float(np.abs(value).max())
        err = float(np.abs(got[prefix + name] - value).max())
        assert err <= tol * scale, (name, err, scale)


def test_int8_calibration_matches_jax_on_the_global_batch(engine_runs):
    """Each rank's table is, bit for bit, the port's one-process
    calibration of the global batch (the halves' maxima differ: the second
    half is darker), and within INT8_RTOL of JAX's."""
    ref, whole = engine_runs["jax"]["scales"], engine_runs["one_process_scales"]
    tables = [{k[len("scale/"):]: v for k, v in rank.items() if k.startswith("scale/")}
              for rank in engine_runs["ranks"]]
    for got in tables:
        assert set(got) == set(ref) == set(whole) and "stem" in got
        for name, value in got.items():
            np.testing.assert_array_equal(value, whole[name], err_msg=name)
            np.testing.assert_allclose(value, ref[name], rtol=INT8_RTOL, err_msg=name)


def test_random_draws_are_the_global_batch_rows(engine_runs):
    got = np.concatenate([rank["random"] for rank in engine_runs["ranks"]])
    np.testing.assert_array_equal(got, engine_runs["jax"]["random"])


def test_rand_augment_rows_match_jax(engine_runs):
    ref_img, ref_heat = engine_runs["jax"]["aug"]
    got_img = np.concatenate([rank["aug/images"] for rank in engine_runs["ranks"]])
    got_heat = np.concatenate([rank["aug/heat"] for rank in engine_runs["ranks"]])
    np.testing.assert_allclose(got_img, ref_img, rtol=0, atol=ROT_ATOL / 255 / 0.224 + 1e-5)
    np.testing.assert_allclose(got_heat, ref_heat, rtol=0, atol=HEAT_ATOL)


# -- the CLI under torchrun ---------------------------------------------------------

YAML = """
EXPR_NAME: "cli"
EXPR_TYPE: "SAL"
LOG_DIR: "{log_dir}"
RESULTS: "{log_dir}/results.json"
AL:
  STRATEGY: "CORESET"
  INITIAL_AMOUNT: {al}
  ITER_AMOUNT: {al}
  ITERATIONS: 2
  INFERENCE: {{BATCH_SIZE: 2, NUM_WORKERS: 0}}
SAL: {{NUM_FRAMES: [0, {sal}], INLIER_THRESHOLD: 0}}
TRAIN:
  BATCH_SIZE: 2
  VAL_SIZE: 2
  NUM_WORKERS: 0
  LOG_EVERY_ITER: 2
  OPTIM: {{TOTAL_STEPS: 2, LR: 1.0e-9}}
POSE_ESTIMATOR: {{TYPE: "POSE_RESNET", NUM_LAYERS: 18}}
DATA:
  TYPE: "synthetic"
  SYNTHETIC_ROOT: "{tree}"
  NUM_JOINTS: {joints}
  INPUT_WIDTH: 32
  INPUT_HEIGHT: 32
  EPOCH_SIZE: 2
  USE_NATIVE_LOADER: false
TPU: {{COMPUTE_DTYPE: "float32", INT8_SCORING: false, DATA_AXIS: {data_axis},
      VIEW_AXIS: {view_axis}}}
"""

# Installed in each rank through PYTHONPATH: refuses the banned modules, and
# records, at exit, which of them were loaded and every file the rank
# opened for writing.
SITECUSTOMIZE = textwrap.dedent("""
    import atexit, builtins, io, json, os, sys
    BANNED = %r
    _writes = []

    class _Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError("banned import: " + name)
            return None

    sys.meta_path.insert(0, _Refuse())
    _open = builtins.open

    def _recording_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and isinstance(file, (str, bytes, os.PathLike)):
            _writes.append(os.path.abspath(os.fsdecode(file)))
        return _open(file, mode, *args, **kwargs)

    builtins.open = io.open = _recording_open

    def _report():
        banned = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
        with _open(os.path.join(os.environ["RANK_REPORT_DIR"],
                                "rank%%s.json" %% os.environ.get("RANK", "-")), "w") as f:
            json.dump({"banned": banned, "writes": _writes}, f)

    if os.environ.get("RANK_REPORT_DIR") and "RANK" in os.environ:  # a rank, not the agent
        atexit.register(_report)
""") % (BANNED,)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return generate_panoptic_tree(str(tmp_path_factory.mktemp("tree")),
                                  num_train_frames=TRAIN_FRAMES, num_val_frames=2,
                                  num_joints=JOINTS, num_cameras=CAMS)


def _write_cfg(root, side, tree, data_axis=-1, view_axis=1):
    log_dir = os.path.join(root, side)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(YAML.format(log_dir=log_dir, al=AL_FRAMES, sal=SAL_FRAMES, tree=tree,
                            joints=JOINTS, data_axis=data_axis, view_axis=view_axis))
    return path, log_dir


def _torchrun(path, report_dir):
    """The port's CLI under torchrun, 2 ranks on gloo, started (not waited
    for)."""
    hooks = os.path.join(report_dir, "hooks")
    os.makedirs(hooks, exist_ok=True)
    with open(os.path.join(hooks, "sitecustomize.py"), "w") as f:
        f.write(SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([hooks, REPO]), RANK_REPORT_DIR=report_dir,
               OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(WORLD),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "multi_view_active_learning_tpu_torch.workflow", "--config_file", path,
           "--device", "cpu"]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


class _CoreSetSpy:
    def __init__(self, ops):
        self._ops = ops
        self.built = []

    def CoreSet(self, *args, **kwargs):
        self.built.append(self._ops.CoreSet(*args, **kwargs))
        return self.built[-1]


@pytest.fixture(scope="module")
def cli(tree, tmp_path_factory):
    """The port's 2-rank CLI run and the JAX CLI on the 2-device mesh."""
    root = str(tmp_path_factory.mktemp("cli"))
    port_path, port_dir = _write_cfg(root, "port", tree)
    reports = os.path.join(root, "reports")
    proc = _torchrun(port_path, reports)
    try:
        jax_path, jax_dir = _write_cfg(root, "jax", tree)
        cfg = get_default_configs()
        cfg.merge_from_file(port_path)
        engine = Engine(cfg, "cpu")
        weights = {}

        def new_state(self, salt=0):
            seed = (int(self.al_cfg.RANDOM_SEED) + salt) & 0x7FFFFFFF
            if seed not in weights:
                sd = engine.init_state(torch.Generator().manual_seed(seed)).state_dict()
                weights[seed] = jax_convert.torch_state_dict_to_flax(
                    {k: v.numpy() for k, v in sd.items()}, "POSE_RESNET")
            params, stats = weights[seed]
            return self._maybe_replicate(JaxTrainState(
                step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                opt_state=self.engine.tx.init(params)))

        mesh = jax_parallel.make_mesh(WORLD, 1, jax.devices()[:WORLD])
        spy = _CoreSetSpy(jax_strategy_mod.coreset_ops)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxStrategy, "new_state", new_state)
            mp.setattr(jax_workflow, "mesh_from_config", lambda cfg: mesh)
            mp.setattr(jax_metrics_writer, "_try_tb", lambda log_dir: None)
            mp.setattr(jax_strategy_mod, "coreset_ops", spy)
            jax_workflow.main(["--config_file", jax_path])
    finally:
        out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-8000:]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(reports, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    yield dict(port=port_dir, jax=jax_dir, out=out, ranks=ranks, coreset=spy.built)
    shutil.rmtree(root, ignore_errors=True)


def _expr_dir(log_dir):
    names = [n for n in os.listdir(log_dir) if os.path.isdir(os.path.join(log_dir, n))]
    assert len(names) == 1, names
    return os.path.join(log_dir, names[0])


def _logs(log_dir):
    expr = _expr_dir(log_dir)
    out = {}
    for name in sorted(os.listdir(expr)):
        if "GUID" in name or name.startswith("SAL-DICT"):
            with open(os.path.join(expr, name), "rb") as f:
                out[name] = f.read()
    return out


def _assert_gaps(values, count, what):
    for a, b in zip(values[:count], values[1:count + 1]):
        tol = 2 * (METRIC_ATOL + METRIC_RTOL * max(abs(a), abs(b)))
        assert abs(a - b) > tol, "%s: rank gap %g within the tolerance %g" % (what, abs(a - b), tol)


def _greedy_gaps(features, n_sal, picks):
    """k-center greedy in float64 (labeled rows after the first `n_sal`): at
    each step, the winner's distance to its nearest center less the
    runner-up's."""
    x = np.asarray(features, np.float64)
    dist = np.linalg.norm(x[:n_sal, None] - x[None, n_sal:], axis=-1).min(axis=1)
    gaps = []
    for _ in range(picks):
        order = np.argsort(-dist, kind="stable")
        gaps.append(dist[order[0]] - dist[order[1]])
        dist = np.minimum(dist, np.linalg.norm(x[:n_sal] - x[order[0]], axis=-1))
    return gaps


def _centered(kp):
    kp = np.asarray(kp, np.float64)[:, :3]
    return (kp - kp[ROOT]).T.reshape(-1)


def test_cli_guid_logs_are_byte_equal(cli):
    got, ref = _logs(cli["port"]), _logs(cli["jax"])
    assert sorted(got) == sorted(ref) == ["SAL-DICT-ITER-1", "SAL-GUID-ITER-1",
                                         "SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1"]
    sal, jsal = json.loads(got["SAL-DICT-ITER-1"]), json.loads(ref["SAL-DICT-ITER-1"])
    # The k-center picks: JAX's greedy gaps against what the keypoints'
    # difference can move a distance (four times the largest row change).
    (cs,) = cli["coreset"]
    row_err = max(np.linalg.norm(_centered(sal["pred_3d_keypoints"][g])
                                 - _centered(jsal["pred_3d_keypoints"][g]))
                  for g in jsal["pred_3d_keypoints"])
    for step, gap in enumerate(_greedy_gaps(np.asarray(cs.features), cs.n_sal, AL_FRAMES)):
        assert gap > 4 * row_err, "greedy step %d: gap %g within %g" % (step, gap, 4 * row_err)
    al_set = set(json.loads(got["SAMPLED-GUID-ITER-1"]))
    cand = sorted(v for g, v in sal["sal_metric"].items() if g not in al_set)
    _assert_gaps(cand, min(2 * SAL_FRAMES, len(cand) - 1), "sal_metric")
    for name in ("SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1", "SAL-GUID-ITER-1"):
        assert got[name] == ref[name], name
    assert len(json.loads(got["SAMPLED-GUID-ITER-1"])) == AL_FRAMES
    assert len(json.loads(got["SAL-GUID-ITER-1"])) == SAL_FRAMES


def _layout_order(pool_order, batch):
    """The keys of a sweep over `pool_order` by WORLD ranks in batches of
    `batch`, in the order the ranks' gathered batches give them."""
    shards = [pool_order[r::WORLD] for r in range(WORLD)]
    out = []
    for i in range(-(-max(len(s) for s in shards) // batch)):
        for shard in shards:
            out += shard[i * batch:(i + 1) * batch]
    return out


def test_cli_sal_dict_matches_jax(cli):
    got = json.loads(_logs(cli["port"])["SAL-DICT-ITER-1"])
    ref = json.loads(_logs(cli["jax"])["SAL-DICT-ITER-1"])
    assert list(got) == list(ref)
    # JAX's one process walks the pool in order; the ranks' gathered
    # batches give the global batches' order (JAX's multi-process order).
    order = _layout_order(list(ref["al_metric"]), 2)
    assert len(ref["al_metric"]) == TRAIN_FRAMES - AL_FRAMES
    for metric in ref:
        assert list(got[metric]) == order, metric
    for guid in ref["al_metric"]:
        assert got["inlier_count"][guid] == ref["inlier_count"][guid], guid
        for metric in ("al_metric", "sal_metric", "mkpe"):
            assert got[metric][guid] == pytest.approx(ref[metric][guid], rel=METRIC_RTOL,
                                                      abs=METRIC_ATOL), (metric, guid)
        np.testing.assert_allclose(got["pred_3d_keypoints"][guid], ref["pred_3d_keypoints"][guid],
                                   rtol=0, atol=KP_ATOL, err_msg=guid)


def test_cli_results_match_jax(cli):
    with open(os.path.join(cli["port"], "results.json")) as f:
        got = json.load(f)
    with open(os.path.join(cli["jax"], "results.json")) as f:
        ref = json.load(f)
    assert list(got) == list(ref) == [str(AL_FRAMES), str(2 * AL_FRAMES)]
    for size in ref:
        g, r = got[size], ref[size]
        assert np.isfinite(g["mkpe"])
        np.testing.assert_allclose(g["mkpe"], r["mkpe"], rtol=0, atol=RESULT_ATOL)
        for key in ("thresholds", "pckh_thresholds"):
            assert list(g[key]) == list(r[key]), key
        for key in ("pcks", "pckh_pcks"):
            np.testing.assert_allclose(g[key], r[key], rtol=0, atol=RESULT_ATOL, err_msg=key)


def test_cli_rank_zero_writes_once(cli):
    expr = _expr_dir(cli["port"])  # one experiment directory: one stamp
    for sub in ("ITER-0", "ITER-1"):
        names = sorted(os.listdir(os.path.join(expr, sub, "checkpoints")))
        assert len(names) == 2 and names[1] == "CKPT-FINAL" and names[0].startswith("CKPT-E2-"), names
    stamps = re.findall(r"expr_name='([^']*)'", cli["out"])
    assert len(stamps) == WORLD and len(set(stamps)) == 1, stamps
    assert os.path.basename(expr) == stamps[0]
    writes = [[w for w in rank["writes"] if w.startswith(cli["port"])] for rank in cli["ranks"]]
    assert any("CKPT-FINAL" in w for w in writes[0]) and any("SAMPLED-GUID" in w for w in writes[0])
    assert set(writes[1]) == {os.path.join(cli["port"], "results.json")}, writes[1]


def test_cli_ranks_import_no_jax(cli):
    for rank in cli["ranks"]:
        assert rank["banned"] == [], rank["banned"]


# -- errors ------------------------------------------------------------------------

ERROR_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, %r)
    from multi_view_active_learning_tpu_torch import workflow
    from multi_view_active_learning_tpu_torch import parallel
    try:
        workflow.main(["--config_file", sys.argv[1], "--device", "cpu"])
    except (ValueError, NotImplementedError) as e:
        print("RAISED", type(e).__name__, e)
    print("MESH", parallel.make_mesh(-1, 2))
""") % (REPO,)


@pytest.mark.parametrize("how", ["data_axis", "view_axis"])
def test_mesh_mismatch_raises_under_two_ranks(tree, tmp_path, how):
    path, _ = _write_cfg(str(tmp_path), how, tree, data_axis=4 if how == "data_axis" else -1,
                         view_axis=4 if how == "view_axis" else 1)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", ERROR_SCRIPT, path], env=_rank_env(r, port),
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    for out in _wait(procs, timeout=300):
        if how == "data_axis":
            assert "RAISED ValueError mesh 4x1 does not match 2 processes" in out, out[-3000:]
        else:
            assert "RAISED ValueError view_axis (4) must divide the device count (2)" in out, \
                out[-3000:]
        assert "MESH Mesh(data=1, view=2)" in out, out[-3000:]
    assert parallel.process_count() == 1  # this process joined no group
