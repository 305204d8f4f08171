"""View sharding of the port (``TPU.VIEW_AXIS > 1``, ROADMAP A9b) against
the JAX package's ``('data', 'view')`` mesh.  The port's ranks are torch
processes on gloo on the CPU, each a subprocess with torchrun's
environment; rank r is data row ``r // view`` and view column ``r % view``
(JAX's ``devices.reshape(data, view)``).  A rank holds its data row's
frames and, when the view axis divides a frame's views, its column's block
of them; the camera arrays hold every view.

  * **Engine.** A 2 x 2 grid (four ranks) against JAX's ``make_mesh(2, 2,
    devices=jax.devices()[:4])`` (tests/conftest.py forces 8 host devices)
    on the same weights (``from_flax``) and numpy inputs, ResNet-18 float32
    64x64, K=4, B=1 frame a data row, at V=4 (views split: two a rank) and
    V=3 (views replicated on the view axis, as JAX replicates an array whose
    view count does not divide it), both in one rank script: score_step
    TRIANGULATION, MPE (STD), CORESET with EMBEDDING features and RANDOM,
    eval_step, loss_step, RandAugment's draws on each rank's crops
    (``device_prepare`` with DATA.NUM_AUG 2, 32x32 frames), and two
    train_steps at LR (losses, weights) and two at a
    step whose LR has decayed to 0 (BN statistics, Adam's moments), at
    tests/test_torch_distributed.py's tolerances.  Every rank
    of a data row scores the same frames and every rank holds the same
    trained state, bit for bit.
  * **CLI.** ``torch.distributed.run`` of two ranks as a 1 x 2 grid (one
    data row, two view columns, 4 cameras) against the port's own
    one-process run of the same config: the layout invariance of JAX's
    tests/test_workflow.py:226-270.  Guid logs byte-equal, the sal_dict
    within that test's rel / abs 1e-4.
  * **make_mesh.** The rank layout, a view axis that does not divide the
    world, and data x view that is not the world, with JAX's messages.
"""

import hashlib
import json
import os
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

from helpers import golden_fill_values, make_ring_cameras
from multi_view_active_learning_tpu import parallel as jax_parallel
from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.data.pipeline import device_prepare as jax_device_prepare
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu_torch import parallel, workflow
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
from multi_view_active_learning_tpu_torch.models.convert import from_flax
from multi_view_active_learning_tpu_torch.ops.heatmap import render_gaussian_heatmaps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA, VIEW = 2, 2
WORLD = DATA * VIEW
B, K, IMG, LR = 1, 4, 64, 1e-5
VIEW_COUNTS = (4, 3)  # split over the view axis, replicated on it
# tests/test_torch_engine.py's float32 bars for the scores, and
# tests/test_torch_distributed.py's for the train steps (two of them).  The
# random frames' heatmaps triangulate to points up to 6e4 units off the
# rig, where float32 RANSAC sums in another order move a coordinate by
# 1e-4 of its size: keypoints and MKPE are held to their atol plus
# METRIC_RTOL of their size.
KP_ATOL, METRIC_RTOL, METRIC_ATOL, MKPE_ATOL = 1e-2, 1e-4, 1e-3, 1e-2
EMBED_ATOL_OF_SCALE = 1e-4
MU_TOL, NU_TOL = 0.1, 0.05
# RandAugment on the crops of each rank against JAX's device_prepare of the
# global batch (tests/test_torch_augmentation.py's tolerances), on 32x32
# frames; loss_step rtol 1e-4 (tests/test_torch_engine.py's).
AUG_IMG, ROT_ATOL, HEAT_ATOL = 32, 2e-3, 1e-5
FROZEN_STEP = 3000 * 50  # LR * 0.1 ** 50 underflows to 0 in float32


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank, port, world=WORLD):
    env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _configure(cfg):
    cfg.DATA.NUM_JOINTS = K
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = IMG
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TRAIN.OPTIM.LR = LR
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.AL.CORESET_FEATURES = "EMBEDDING"
    return cfg


# -- the engine on a 2 x 2 grid ---------------------------------------------------

ENGINE_SCRIPT = textwrap.dedent("""
    import hashlib, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, %r)
    from multi_view_active_learning_tpu_torch import parallel
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.data.pipeline import device_prepare
    from multi_view_active_learning_tpu_torch.engine import Engine

    inputs, out_path = sys.argv[1], sys.argv[2]
    assert parallel.initialize_distributed(device="cpu")
    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = %d
    cfg.DATA.INPUT_WIDTH = cfg.DATA.INPUT_HEIGHT = %d
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TRAIN.OPTIM.LR = %r
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.AL.CORESET_FEATURES = "EMBEDDING"
    cfg.TPU.DATA_AXIS, cfg.TPU.VIEW_AXIS = %d, %d
    engine = Engine(cfg, device="cpu")
    rank, row = parallel.process_index(), parallel.data_index()
    assert (row, parallel.view_index()) == divmod(rank, %d)
    data = np.load(inputs)
    rows = slice(row * %d, (row + 1) * %d)
    load = lambda prefix: {k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files
                           if k.startswith(prefix)}
    engine.load_state_dict(load("score_w/"))
    init = load("train_w/")
    out = {}
    for V in %r:
        views = parallel.view_slice(V)
        assert parallel.views_split(V) == (V %% %d == 0)
        d = {k: data["v%%d/%%s" %% (V, k)][rows] for k in ("u8", "proj", "jv", "kp3d")}
        d.update({k: data["v%%d/%%s" %% (V, k)][:, rows] for k in ("images", "gt", "pvjv", "fv")})
        u8 = d["u8"][:, views]
        pairs = engine.pairs(V)
        for strategy, agg in (("TRIANGULATION", "AVG"), ("MPE", "STD"), ("CORESET", "AVG"),
                              ("RANDOM", "AVG")):
            res = engine.score_step(u8, d["proj"], d["jv"], pairs, d["kp3d"], al_strategy=strategy,
                                    key=data["key"], mpe_aggregate=agg)
            for name, value in res.items():
                out["v%%d/%%s/%%s" %% (V, strategy, name)] = value.numpy()
        res = engine.eval_step(u8, d["proj"], d["jv"], pairs)
        out["v%%d/eval" %% V] = res["keypoints_3d"].numpy()
        out["v%%d/loss_step" %% V] = engine.loss_step(
            u8, d["gt"][0][:, views], num_views=V).numpy()
        images, heat = device_prepare(
            torch.from_numpy(data["v%%d/aug_u8" %% V][rows][:, views]),
            torch.from_numpy(data["v%%d/aug_kp" %% V][rows][:, views]),
            torch.from_numpy(data["v%%d/aug_sigma" %% V][rows]), data["key"], stride=4, train=True,
            num_aug=2, magnitude=9, use_rotation=True, use_image_aug=True, const_magnitude=False,
            num_views=V)
        out["v%%d/aug/images" %% V], out["v%%d/aug/heat" %% V] = images.numpy(), heat.numpy()
        for run, step in (("lr", 0), ("frozen", %d)):
            state = engine.state_from_state_dict(init, step=step)
            losses = []
            for i in range(2):
                state, metrics = engine.train_step(
                    state, torch.from_numpy(d["images"][i][:, views]),
                    torch.from_numpy(d["gt"][i][:, views]), torch.from_numpy(d["pvjv"][i]),
                    torch.from_numpy(d["fv"][i]))
                assert not bool(metrics["skipped"])
                losses.append(float(metrics["loss"]))
            tag = "v%%d/%%s/" %% (V, run)
            out[tag + "losses"] = np.array(losses)
            for kind in ("params", "buffers", "mu", "nu"):
                flat = state.flat[kind].numpy()
                out[tag + "sha/" + kind] = np.frombuffer(
                    hashlib.sha256(flat.tobytes()).digest(), np.uint8)
                if rank == 0:
                    for name, value in getattr(state, kind).items():
                        out[tag + kind + "/" + name] = value.numpy()
            out[tag + "count"] = np.array([int(state.count), int(state.step)])
    np.savez(out_path, **out)
    parallel.shutdown()
    print("RANK_OK", rank)
""") % (REPO, K, IMG, LR, DATA, VIEW, VIEW, B, B, VIEW_COUNTS, VIEW, FROZEN_STEP)


def _inputs(V, rng):
    """The global batch of DATA * B frames at V views: uint8 frames and
    cameras for scoring, and two training batches."""
    n = DATA * B
    out = {}
    out["u8"] = rng.integers(0, 256, size=(n, V, IMG, IMG, 3)).astype(np.uint8)
    out["proj"] = np.ascontiguousarray(np.broadcast_to(
        make_ring_cameras(V, img=IMG, focal=65.0), (n, V, 3, 4))).astype(np.float32)
    out["jv"] = np.ones((n, K), bool)
    out["jv"][0, 1] = False
    out["kp3d"] = rng.normal(scale=20.0, size=(n, K, 3)).astype(np.float32)
    out["images"] = rng.normal(size=(2, n, V, IMG, IMG, 3)).astype(np.float32)
    kp = rng.uniform(2, IMG - 2, size=(2, n, V, K, 2)).astype(np.float32)
    out["gt"] = render_gaussian_heatmaps(torch.from_numpy(kp / 4), IMG // 4, IMG // 4, 2.0).numpy()
    out["pvjv"] = rng.random((2, n, V, K)) > 0.2
    out["fv"] = np.ones((2, n), bool)
    out["aug_u8"] = rng.integers(0, 256, size=(n, V, AUG_IMG, AUG_IMG, 3)).astype(np.uint8)
    out["aug_kp"] = rng.uniform(0, AUG_IMG, size=(n, V, K, 2)).astype(np.float32)
    out["aug_sigma"] = rng.uniform(1.5, 2.5, size=(n,)).astype(np.float32)
    return out


def _score_weights():
    """Flax (params, batch_stats) with O(1) activations, from seeded numpy
    (tests/test_torch_engine.py's), so the heatmaps have peaks to decode."""
    jax_engine = JaxEngine(_configure(jax_configs()))
    shapes = jax.eval_shape(lambda: jax_engine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3)))
    zeros = jax_convert.flax_to_torch_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.params),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.batch_stats),
        "POSE_RESNET")
    values = golden_fill_values(list(zeros), [a.shape for a in zeros.values()], 5)
    return jax_convert.torch_state_dict_to_flax(values, "POSE_RESNET")


def _torch_named(tree):
    return {k: v.numpy() for k, v in from_flax(jax.device_get(tree), {}).items()}


def _jax_reference(mesh, data, score_w, state0):
    """JAX's scores, eval and two train steps of each V on the 2 x 2 mesh.
    Per-view arrays shard (data, view) when the view axis divides V, else
    (data,) only (JAX strategy.py::_put)."""
    jengine = JaxEngine(_configure(jax_configs()))
    params, stats = jax_parallel.replicate_tree(mesh, score_w)
    ref = {}

    def put(a, per_view):
        split = per_view and a.ndim >= 2 and a.shape[1] % VIEW == 0
        sh = (jax_parallel.batch_sharding(mesh, a.ndim, 1) if split
              else jax_parallel.data_sharding(mesh, a.ndim))
        return jax.device_put(a, sh)

    for V in VIEW_COUNTS:
        d = data[V]
        args = (put(d["u8"], True), put(d["proj"], True), put(d["jv"], False),
                jnp.asarray(jengine.pairs(V)), put(d["kp3d"], False))
        for strategy, agg in (("TRIANGULATION", "AVG"), ("MPE", "STD"), ("CORESET", "AVG")):
            res = jengine.score_step(params, stats, *args, jax.random.PRNGKey(0),
                                     al_strategy=strategy, mpe_aggregate=agg)
            for name, value in res.items():
                ref["v%d/%s/%s" % (V, strategy, name)] = np.asarray(value)
        ref["v%d/eval" % V] = np.asarray(jengine.eval_step(params, stats, *args[:4])["keypoints_3d"])
        ref["v%d/loss_step" % V] = np.asarray(jengine.loss_step(
            params, stats, args[0], put(np.moveaxis(d["gt"][0], 2, -1), True)))
        img, heat = jax_device_prepare(
            put(d["aug_u8"], True), put(d["aug_kp"], True), put(d["aug_sigma"], False),
            jnp.asarray(d["key"]), stride=4, train=True, num_aug=2, magnitude=9,
            use_rotation=True, use_image_aug=True, const_magnitude=False)
        ref["v%d/aug" % V] = (np.asarray(img), np.moveaxis(np.asarray(heat), -1, 2))
        ref["v%d/RANDOM" % V] = np.asarray(jax.random.uniform(jnp.asarray(d["key"]), (DATA * B,)))
        for run, step in (("lr", 0), ("frozen", FROZEN_STEP)):
            state = jax_parallel.replicate_tree(mesh, state0.replace(
                step=np.asarray(step, state0.step.dtype)))
            losses = []
            for i in range(2):
                batch = (put(d["images"][i], True), put(np.moveaxis(d["gt"][i], 2, -1), True),
                         put(d["pvjv"][i], True), put(d["fv"][i], False))
                state, metrics = jengine.train_step(state, *batch)
                assert not bool(metrics["skipped"])
                losses.append(float(metrics["loss"]))
            tag = "v%d/%s/" % (V, run)
            ref[tag + "losses"] = np.array(losses)
            ref[tag + "state"] = from_flax(*jax.device_get((state.params, state.batch_stats)))
            ref[tag + "mu"] = _torch_named(state.opt_state.mu)
            ref[tag + "nu"] = _torch_named(state.opt_state.nu)
            ref[tag + "count"] = [int(state.opt_state.count), int(state.step)]
    return ref


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """{"ranks": each rank's outputs, "jax": the references}."""
    tmp = tmp_path_factory.mktemp("grid")
    rng = np.random.default_rng(0)
    data = {V: _inputs(V, rng) for V in VIEW_COUNTS}
    key = np.asarray(jax.random.PRNGKey(7))
    for V in VIEW_COUNTS:
        data[V]["key"] = key
    score_w = _score_weights()
    jengine = JaxEngine(_configure(jax_configs()))
    state0 = jax.device_get(jengine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3)))
    flat = {"key": key}
    for V in VIEW_COUNTS:
        flat.update({"v%d/%s" % (V, k): v for k, v in data[V].items() if k != "key"})
    flat.update({"score_w/" + k: v.numpy() for k, v in from_flax(*score_w).items()})
    flat.update({"train_w/" + k: v.numpy()
                 for k, v in from_flax(state0.params, state0.batch_stats).items()})
    path = str(tmp / "inputs.npz")
    np.savez(path, **flat)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", ENGINE_SCRIPT, path, str(tmp / ("r%d.npz" % r))],
                              env=_rank_env(r, port), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = _jax_reference(jax_parallel.make_mesh(DATA, VIEW, devices=jax.devices()[:WORLD]),
                             data, score_w, state0)
    finally:
        outs = []
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0 and "RANK_OK" in out, out[-6000:]
    ranks = [dict(np.load(str(tmp / ("r%d.npz" % r)))) for r in range(WORLD)]
    shutil.rmtree(tmp, ignore_errors=True)  # the suite shares one disk
    return dict(ranks=ranks, jax=ref)


def _rows(grid, name):
    """The global batch's rows of `name`: each data row's from its view
    column 0 rank, after checking every rank of the row holds the same."""
    parts = []
    for row in range(DATA):
        first = grid["ranks"][row * VIEW][name]
        for v in range(1, VIEW):
            np.testing.assert_array_equal(grid["ranks"][row * VIEW + v][name], first, err_msg=name)
        parts.append(first)
    return np.concatenate(parts)


@pytest.mark.parametrize("V", VIEW_COUNTS)
@pytest.mark.parametrize("strategy", ["TRIANGULATION", "MPE", "CORESET", "RANDOM"])
def test_score_step_matches_jax(grid, V, strategy):
    prefix = "v%d/%s/" % (V, strategy)
    ref = grid["jax"]
    tri = "v%d/TRIANGULATION/" % V
    np.testing.assert_array_equal(_rows(grid, prefix + "inlier_count"), ref[tri + "inlier_count"])
    np.testing.assert_allclose(_rows(grid, prefix + "keypoints_3d"), ref[tri + "keypoints_3d"],
                               rtol=METRIC_RTOL, atol=KP_ATOL)
    np.testing.assert_allclose(_rows(grid, prefix + "sal_metric"), ref[tri + "sal_metric"],
                               rtol=METRIC_RTOL, atol=METRIC_ATOL)
    np.testing.assert_allclose(_rows(grid, prefix + "mkpe"), ref[tri + "mkpe"],
                               rtol=METRIC_RTOL, atol=MKPE_ATOL)
    got = _rows(grid, prefix + "al_metric")
    if strategy == "RANDOM":
        np.testing.assert_array_equal(got, ref["v%d/RANDOM" % V])
    elif strategy == "CORESET":
        emb, ref_emb = _rows(grid, prefix + "embedding"), ref[prefix + "embedding"]
        scale = float(np.abs(ref_emb).max())
        assert float(np.abs(emb - ref_emb).max()) <= EMBED_ATOL_OF_SCALE * scale
    else:
        assert np.ptp(got) > 0, got  # the two frames score apart
        np.testing.assert_allclose(got, ref[prefix + "al_metric"], rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL)


@pytest.mark.parametrize("V", VIEW_COUNTS)
def test_eval_step_matches_jax(grid, V):
    np.testing.assert_allclose(_rows(grid, "v%d/eval" % V), grid["jax"]["v%d/eval" % V],
                               rtol=METRIC_RTOL, atol=KP_ATOL)


def _crops(grid, name, V):
    """The global [DATA * B, V, ...] batch of a per-rank [B, V_local, ...]
    output: each data row's ranks' views side by side (all of them from
    view column 0 when the views are replicated)."""
    rows = []
    for row in range(DATA):
        ranks = grid["ranks"][row * VIEW:(row + 1) * VIEW]
        if V % VIEW:
            rows.append(ranks[0][name])
        else:
            rows.append(np.concatenate([rank[name] for rank in ranks], axis=1))
    return np.concatenate(rows)


@pytest.mark.parametrize("V", VIEW_COUNTS)
def test_loss_step_and_rand_augment_match_jax(grid, V):
    """loss_step sums a frame's views over the view group; RandAugment
    gives each rank's crops their rows' draws of the global batch."""
    np.testing.assert_allclose(_rows(grid, "v%d/loss_step" % V), grid["jax"]["v%d/loss_step" % V],
                               rtol=1e-4)
    ref_img, ref_heat = grid["jax"]["v%d/aug" % V]
    np.testing.assert_allclose(_crops(grid, "v%d/aug/images" % V, V), ref_img, rtol=0,
                               atol=ROT_ATOL / 255 / 0.224 + 1e-5)
    np.testing.assert_allclose(_crops(grid, "v%d/aug/heat" % V, V), ref_heat, rtol=0,
                               atol=HEAT_ATOL)


@pytest.mark.parametrize("V", VIEW_COUNTS)
def test_train_steps_match_jax_and_ranks_agree(grid, V):
    """Two steps at LR: losses and weights; two at a step whose LR has
    decayed to 0 (the weights stay put): BN running statistics and Adam's
    moments.  Every rank ends with the same flat buffers, bit for bit."""
    ranks, ref = grid["ranks"], grid["jax"]
    got = ranks[0]
    for run in ("lr", "frozen"):
        tag = "v%d/%s/" % (V, run)
        for rank in ranks[1:]:
            for kind in ("params", "buffers", "mu", "nu"):
                np.testing.assert_array_equal(rank[tag + "sha/" + kind], got[tag + "sha/" + kind],
                                              err_msg=kind)
            np.testing.assert_array_equal(rank[tag + "losses"], got[tag + "losses"])
        np.testing.assert_allclose(got[tag + "losses"], ref[tag + "losses"], rtol=1e-4)
        assert list(got[tag + "count"]) == ref[tag + "count"] == [
            2, 2 + (FROZEN_STEP if run == "frozen" else 0)]
    state = ref["v%d/lr/state" % V]
    prefix = "v%d/lr/params/" % V
    names = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert names and set(names) <= set(state)
    for name in names:
        err = float(np.abs(got[prefix + name] - state[name].numpy()).max())
        assert err <= 2 * 2 * LR, (name, err)
    state = ref["v%d/frozen/state" % V]
    prefix = "v%d/frozen/buffers/" % V
    names = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert len(names) == len([n for n in state if "running" in n])
    worst = max(float(np.abs(got[prefix + n] - state[n].numpy()).max()) for n in names)
    assert worst <= 1e-5, worst
    for moment, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
        prefix = "v%d/frozen/%s/" % (V, moment)
        moments = ref["v%d/frozen/%s" % (V, moment)]
        assert set(moments) == {k[len(prefix):] for k in got if k.startswith(prefix)}
        for name, value in moments.items():
            scale = float(np.abs(value).max())
            assert float(np.abs(got[prefix + name] - value).max()) <= tol * scale, (moment, name)


# -- the CLI as a 1 x 2 grid ------------------------------------------------------

CAMS, JOINTS, TRAIN_FRAMES, AL_FRAMES, SAL_FRAMES = 4, 4, 16, 2, 4
CLI_RTOL = CLI_ATOL = 1e-4  # JAX tests/test_workflow.py:266-270

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
TPU: {{COMPUTE_DTYPE: "float32", INT8_SCORING: false, VIEW_AXIS: {view_axis}}}
"""


def _write_cfg(root, side, tree, view_axis):
    log_dir = os.path.join(root, side)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(YAML.format(log_dir=log_dir, al=AL_FRAMES, sal=SAL_FRAMES, tree=tree,
                            joints=JOINTS, view_axis=view_axis))
    return path, log_dir


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The CLI under torchrun as a 1 x 2 grid and in one process."""
    root = str(tmp_path_factory.mktemp("vcli"))
    tree = generate_panoptic_tree(os.path.join(root, "tree"), num_train_frames=TRAIN_FRAMES,
                                  num_val_frames=2, num_joints=JOINTS, num_cameras=CAMS)
    grid_path, grid_dir = _write_cfg(root, "grid", tree, VIEW)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(VIEW),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", "multi_view_active_learning_tpu_torch.workflow", "--config_file", grid_path,
           "--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        one_path, one_dir = _write_cfg(root, "one", tree, 1)
        workflow.main(["--config_file", one_path, "--device", "cpu"])
    finally:
        out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-8000:]
    assert "Mesh: Mesh(data=1, view=2)" in out, out[-3000:]
    yield dict(grid=grid_dir, one=one_dir)
    shutil.rmtree(root, ignore_errors=True)


def _logs(log_dir):
    (name,) = [n for n in os.listdir(log_dir) if os.path.isdir(os.path.join(log_dir, n))]
    expr = os.path.join(log_dir, name)
    out = {}
    for name in sorted(os.listdir(expr)):
        if "GUID" in name or name.startswith("SAL-DICT"):
            with open(os.path.join(expr, name), "rb") as f:
                out[name] = f.read()
    return out


def test_cli_view_grid_guid_logs_equal_one_process(cli):
    got, ref = _logs(cli["grid"]), _logs(cli["one"])
    assert sorted(got) == sorted(ref) == ["SAL-DICT-ITER-1", "SAL-GUID-ITER-1",
                                         "SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1"]
    for name in ("SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1", "SAL-GUID-ITER-1"):
        assert got[name] == ref[name], name
    assert len(json.loads(got["SAMPLED-GUID-ITER-1"])) == AL_FRAMES
    assert len(json.loads(got["SAL-GUID-ITER-1"])) == SAL_FRAMES


def test_cli_view_grid_sal_dict_equals_one_process(cli):
    got = json.loads(_logs(cli["grid"])["SAL-DICT-ITER-1"])
    ref = json.loads(_logs(cli["one"])["SAL-DICT-ITER-1"])
    assert list(got) == list(ref)
    assert len(ref["al_metric"]) == TRAIN_FRAMES - AL_FRAMES
    for metric in ref:
        assert list(got[metric]) == list(ref[metric]), metric
    for guid in ref["al_metric"]:
        assert got["inlier_count"][guid] == ref["inlier_count"][guid], guid
        for metric in ("al_metric", "sal_metric", "mkpe"):
            assert got[metric][guid] == pytest.approx(ref[metric][guid], rel=CLI_RTOL,
                                                      abs=CLI_ATOL), (metric, guid)
        np.testing.assert_allclose(got["pred_3d_keypoints"][guid], ref["pred_3d_keypoints"][guid],
                                   rtol=CLI_RTOL, atol=CLI_ATOL, err_msg=guid)


# -- make_mesh --------------------------------------------------------------------


def test_make_mesh_rank_layout():
    """Rank r is data row r // view and view column r % view, as JAX's
    devices.reshape(data, view) lays out its devices."""
    devices = np.arange(8)
    mesh = parallel.make_mesh(-1, 2, world=8)
    assert mesh == parallel.Mesh(4, 2)
    ref = jax_parallel.make_mesh(-1, 2, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    np.testing.assert_array_equal(ids, devices.reshape(mesh.data, mesh.view))
    for r in range(8):
        assert divmod(r, mesh.view) == tuple(np.argwhere(ids == r)[0])


@pytest.mark.parametrize("data_axis,view_axis,world,message", [
    (-1, 3, 4, r"view_axis \(3\) must divide the device count \(4\)"),
    (3, 2, 4, r"mesh 3x2 does not match 4 processes"),
])
def test_make_mesh_mismatch_raises_as_jax(data_axis, view_axis, world, message):
    with pytest.raises(ValueError, match=message):
        parallel.make_mesh(data_axis, view_axis, world=world)
    jax_message = message.replace("processes", "devices")
    with pytest.raises(ValueError, match=jax_message):
        jax_parallel.make_mesh(data_axis, view_axis, devices=jax.devices()[:world])
