"""The port's ActiveLearningStrategy: the pool sweep and the AL step.

  * Against the reference's own sweep (tests/fixtures/sal_dict_goldens.json,
    the reference's `_compute_sal_dict` on a synthetic tree with golden
    weights; see tests/test_sal_parity.py): the port's `_compute_sal_dict`
    on the same tree and weights, PoseResNet-50 in all nine variants and
    HRNet-W32 for TRIANGULATION and MPE_AVG, float32 with the SVD solver on
    the PIL path, B=2.  Tolerances of tests/test_sal_parity.py: inlier
    counts exact, metrics rel / abs 1e-3, keypoints rtol 1e-2 / atol 5e-2.
  * Against the JAX package end to end: PoseResNet-18 on 64x64 crops of a
    4-camera, 12-frame tree, the same weights (carried by from_flax),
    EXPR_TYPE=SAL with TRIANGULATION, iterations 0 and 1 of
    sample_next_batch.  The guid logs are byte-equal; SAL-DICT-ITER-1 has
    the same keys and its values agree to the engine tests' float32
    tolerances (inlier counts exact, metrics rtol 1e-4 / atol 1e-3, keypoints
    atol 1e-2).  The rank gaps that decide the selections are asserted to
    exceed those tolerances first.
  * CORESET with EMBEDDING features under SAL, end to end in both packages
    with nothing stubbed: the features CoreSet ranks (the sweep's candidate
    embeddings and `_embed_labeled`'s center embeddings) agree with the JAX
    package's, every greedy pick wins by more than that difference can
    move, and the guid logs are byte-equal.
  * RANDOM under SAL: the port's sweep draws jax.random.uniform along the
    strategy's key stream bit for bit, and the JAX package's selection on
    those draws picks the port's guids.
  * Selection logic: both packages' `_compute_sal_dict` (and
    `_embed_labeled`) return one shared result, and their
    `_sal_pseudo_labeling` must pick the same AL and SAL guids.
"""

import copy
import hashlib
import json
import math
import os
import types

import jax
import numpy as np
import pytest
import torch

from helpers import golden_fill_values
from multi_view_active_learning_tpu import strategy as jax_strategy_mod
from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.data import build_dataset as jax_build_dataset
from multi_view_active_learning_tpu.data.pools import FramePool as JaxFramePool
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data import build_dataset
from multi_view_active_learning_tpu_torch.data.pools import FramePool
from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
from multi_view_active_learning_tpu_torch.models.convert import from_flax
from multi_view_active_learning_tpu_torch import strategy as port_strategy_mod
from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy

GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures", "sal_dict_goldens.json")


# --------------------------------------------------------------------------
# Against the reference's sweep.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    with open(GOLDENS) as f:
        return json.load(f)


def first_jpeg_checksum(tree):
    first = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs
                   if f.endswith(".jpg"))[0]
    with open(first, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def golden_tree(golden, tmp_path_factory):
    meta = golden["meta"]
    tree = generate_panoptic_tree(str(tmp_path_factory.mktemp("sal_tree")),
                                  num_train_frames=meta["num_frames"], num_val_frames=2,
                                  num_joints=meta["num_joints"], num_cameras=meta["num_cams"])
    assert first_jpeg_checksum(tree) == meta["tree_checksum"]
    return tree


def golden_state(golden, tag):
    """The golden weights by reference names (HRNet's final layer scaled by
    head_scale, as the goldens' generator scaled it)."""
    w = golden["models"][tag]["weights"]
    values = golden_fill_values(w["names"], [tuple(s) for s in w["shapes"]],
                                int(golden["meta"]["weight_seed"]))
    scale = np.float32(w.get("head_scale", 1.0))
    return {k: torch.from_numpy(v * scale if k.startswith("final_layer.") else v)
            for k, v in values.items()}


_GOLDEN_STATES = {}


GOLDEN_CASES = ([("pose_resnet50", "POSE_RESNET", v) for v in (
    "TRIANGULATION", "TRI_SOFTARGMAX", "TRI_XE", "MPE_AVG", "MPE_STD", "HP_AVG", "HP_STD",
    "BSB_AVG", "BSB_STD")] + [("hrnet_w32", "HRNET", v) for v in ("TRIANGULATION", "MPE_AVG")])


@pytest.mark.parametrize("tag,model_type,variant", GOLDEN_CASES,
                         ids=["%s-%s" % (t, v) for t, _, v in GOLDEN_CASES])
def test_sal_dict_matches_reference(golden, golden_tree, tag, model_type, variant):
    meta = golden["meta"]
    cfg = get_default_configs()
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = golden_tree
    cfg.DATA.NUM_JOINTS = meta["num_joints"]
    cfg.DATA.USE_NATIVE_LOADER = False  # the reference's PIL path, byte for byte
    cfg.POSE_ESTIMATOR.TYPE = model_type
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 50
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.TPU.DLT_METHOD = "svd"
    cfg.AL.STRATEGY = "TRIANGULATION"
    for key, value in meta["variants"][variant].items():
        setattr(cfg.AL, key, value)
    cfg.AL.INFERENCE.BATCH_SIZE = 2
    cfg.AL.INFERENCE.NUM_WORKERS = 0
    strategy = ActiveLearningStrategy(cfg, device="cpu")
    pool = build_dataset(cfg, "train")
    pool.resample_unlabeled_data()
    if tag not in _GOLDEN_STATES:
        _GOLDEN_STATES[tag] = golden_state(golden, tag)
    sal = strategy._compute_sal_dict(pool, _GOLDEN_STATES[tag])
    gold = golden["models"][tag]["sal_dicts"][variant]
    assert set(sal["al_metric"]) == set(gold["al_metric"])
    for guid in gold["al_metric"]:
        assert sal["inlier_count"][guid] == gold["inlier_count"][guid], guid
        for metric in ("al_metric", "sal_metric", "mkpe"):
            assert sal[metric][guid] == pytest.approx(gold[metric][guid], rel=1e-3, abs=1e-3), (
                metric, guid)
        np.testing.assert_allclose(np.asarray(sal["pred_3d_keypoints"][guid]),
                                   np.asarray(gold["pred_3d_keypoints"][guid]), rtol=1e-2,
                                   atol=5e-2, err_msg=guid)


# --------------------------------------------------------------------------
# Against the JAX package, end to end.
# --------------------------------------------------------------------------

E2E_JOINTS, E2E_CAMS, E2E_FRAMES, E2E_IMG = 5, 4, 12, 64
AL_FRAMES, SAL_FRAMES = 2, 2
METRIC_RTOL, METRIC_ATOL, KP_ATOL = 1e-4, 1e-3, 1e-2


def _e2e_configure(cfg, tree, log_dir, strategy="TRIANGULATION"):
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = tree
    cfg.DATA.NUM_JOINTS = E2E_JOINTS
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = E2E_IMG
    cfg.DATA.USE_NATIVE_LOADER = False
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.TPU.DLT_METHOD = "svd"
    cfg.EXPR_TYPE = "SAL"
    cfg.AL.STRATEGY = strategy
    cfg.SAL.INLIER_THRESHOLD = 1
    cfg.AL.INFERENCE.BATCH_SIZE = 4  # 10 frames at iteration 1: the last batch is padded
    cfg.AL.INFERENCE.NUM_WORKERS = 0
    cfg.LOG_DIR = log_dir
    return cfg


@pytest.fixture(scope="module")
def e2e_tree(tmp_path_factory):
    return generate_panoptic_tree(str(tmp_path_factory.mktemp("e2e_tree")),
                                  num_train_frames=E2E_FRAMES, num_val_frames=2,
                                  num_joints=E2E_JOINTS, num_cameras=E2E_CAMS)


@pytest.fixture(scope="module")
def e2e_weights(e2e_tree, tmp_path_factory):
    """Flax (params, batch_stats) with O(1) activations, from seeded numpy
    (shapes by eval_shape: nothing is compiled)."""
    cfg = _e2e_configure(jax_configs(), e2e_tree, str(tmp_path_factory.mktemp("unused")))
    engine = JaxEngine(cfg)
    shapes = jax.eval_shape(lambda: engine.init_state(jax.random.PRNGKey(0)))
    zeros = jax_convert.flax_to_torch_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.params),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.batch_stats),
        "POSE_RESNET")
    # Seed 7 leaves every rank gap that decides a selection above the
    # tolerance (seed 6 put two sal_metric values 0.0022 apart).
    values = golden_fill_values(list(zeros), [a.shape for a in zeros.values()], 7)
    return jax_convert.torch_state_dict_to_flax(values, "POSE_RESNET")


def _read_logs(cfg):
    d = os.path.join(cfg.LOG_DIR, cfg.EXPR_NAME)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _assert_gaps(values, count, what):
    """The first `count` + 1 of `values` (in selection order) are each
    further from the next than the metric tolerance, so a selection within
    tolerance is the same selection."""
    for a, b in zip(values[:count], values[1:count + 1]):
        tol = 2 * (METRIC_ATOL + METRIC_RTOL * max(abs(a), abs(b)))
        assert abs(a - b) > tol, "%s: rank gap %g within the tolerance %g" % (what, abs(a - b), tol)


@pytest.fixture(scope="module")
def e2e_runs(e2e_tree, e2e_weights, tmp_path_factory):
    """sample_next_batch at iterations 0 and 1 in both packages: (port
    config, JAX config, port pool, JAX pool)."""
    params, stats = e2e_weights
    cfg = _e2e_configure(get_default_configs(), e2e_tree, str(tmp_path_factory.mktemp("port")))
    jcfg = _e2e_configure(jax_configs(), e2e_tree, str(tmp_path_factory.mktemp("jax")))
    port = ActiveLearningStrategy(cfg, device="cpu")
    ref = jax_strategy_mod.ActiveLearningStrategy(jcfg)
    pool, jpool = build_dataset(cfg, "train"), jax_build_dataset(jcfg, "train")
    state = from_flax(params, stats)
    jstate = types.SimpleNamespace(params=params, batch_stats=stats)
    for iteration in (0, 1):
        port.sample_next_batch(pool, AL_FRAMES, SAL_FRAMES, state, iteration)
        ref.sample_next_batch(jpool, AL_FRAMES, SAL_FRAMES, jstate, iteration)
    return cfg, jcfg, pool, jpool


def test_e2e_guid_logs_are_byte_equal(e2e_runs):
    cfg, jcfg, pool, jpool = e2e_runs
    got, ref = _read_logs(cfg), _read_logs(jcfg)
    assert sorted(got) == sorted(ref) == ["SAL-DICT-ITER-1", "SAL-GUID-ITER-1",
                                         "SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1"]
    sal = json.loads(got["SAL-DICT-ITER-1"])
    al_sorted = sorted(sal["al_metric"].values(), reverse=True)
    _assert_gaps(al_sorted, AL_FRAMES, "al_metric")
    al_set = set(json.loads(got["SAMPLED-GUID-ITER-1"]))
    cand = sorted(v for g, v in sal["sal_metric"].items()
                  if g not in al_set and sal["inlier_count"][g] > cfg.SAL.INLIER_THRESHOLD)
    assert len(cand) > 2 * SAL_FRAMES
    _assert_gaps(cand, 2 * SAL_FRAMES, "sal_metric")
    for name in ("SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1", "SAL-GUID-ITER-1"):
        assert got[name] == ref[name], name
    assert [f["guid"] for f in pool.labeled_data] == [f["guid"] for f in jpool.labeled_data]
    assert pool.pseudo_label_guids == jpool.pseudo_label_guids


def _assert_sal_dict_matches(got, ref, frames):
    """`got` has `ref`'s keys in `ref`'s order, and its values agree within
    the float32 tolerances."""
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


def test_e2e_sal_dict_matches_jax(e2e_runs):
    cfg, jcfg, _, _ = e2e_runs
    _assert_sal_dict_matches(json.loads(_read_logs(cfg)["SAL-DICT-ITER-1"]),
                             json.loads(_read_logs(jcfg)["SAL-DICT-ITER-1"]),
                             E2E_FRAMES - AL_FRAMES)


def test_e2e_random_under_sal_draws_jax_stream(e2e_tree, e2e_weights, tmp_path):
    """EXPR_TYPE=SAL with RANDOM scores through the sweep: its al_metric is
    jax.random.uniform(skey, (B,)) along the strategy's key stream (split
    once a batch, padded rows drawing too), bit for bit, and the JAX
    package's selection on those draws picks the port's guids."""
    params, stats = e2e_weights
    cfg = _e2e_configure(get_default_configs(), e2e_tree, str(tmp_path / "port"), "RANDOM")
    jcfg = _e2e_configure(jax_configs(), e2e_tree, str(tmp_path / "jax"), "RANDOM")
    port = ActiveLearningStrategy(cfg, device="cpu")
    pool, jpool = build_dataset(cfg, "train"), jax_build_dataset(jcfg, "train")
    state = from_flax(params, stats)
    for iteration in (0, 1):
        port.sample_next_batch(pool, AL_FRAMES, SAL_FRAMES, state, iteration)
    got = json.loads(_read_logs(cfg)["SAL-DICT-ITER-1"])

    key = jax.random.PRNGKey((cfg.RANDOM_SEED + 7919 * 2) & 0x7FFFFFFF)
    guids = list(got["al_metric"])
    B = cfg.AL.INFERENCE.BATCH_SIZE
    draws = {}
    for start in range(0, len(guids), B):
        key, skey = jax.random.split(key)
        batch = np.asarray(jax.random.uniform(skey, (B,)))
        draws.update(zip(guids[start:start + B], batch))
    for guid in guids:
        assert np.float32(got["al_metric"][guid]).view(np.uint32) == draws[guid].view(np.uint32)

    ref = jax_strategy_mod.ActiveLearningStrategy(jcfg)
    ref._random_sample_frames(jpool, AL_FRAMES)  # iteration 0
    shared = copy.deepcopy(got)
    shared["al_metric"] = {g: float(draws[g]) for g in guids}
    ref._compute_sal_dict = lambda *a, **k: copy.deepcopy(shared)
    al_guids, sal_guids, _ = ref._sal_pseudo_labeling(jpool, AL_FRAMES, SAL_FRAMES, None, 1)
    logs = _read_logs(cfg)
    assert json.dumps(al_guids).encode() == logs["SAMPLED-GUID-ITER-1"]
    assert json.dumps(sal_guids).encode() == logs["SAL-GUID-ITER-1"]


class _CoreSetSpy:
    """Stands in for a strategy module's `coreset_ops`: builds the real
    CoreSet and keeps it, so a test can read the features it ranked."""

    def __init__(self, ops):
        self._ops = ops
        self.built = []

    def CoreSet(self, *args, **kwargs):
        self.built.append(self._ops.CoreSet(*args, **kwargs))
        return self.built[-1]


def _greedy_gaps(features, n_sal, picks):
    """k-center greedy in float64 over `features` (labeled rows after the
    first `n_sal`): at each of `picks` steps, the winner's distance to its
    nearest center less the runner-up's."""
    x = np.asarray(features, np.float64)
    dist = np.linalg.norm(x[:n_sal, None] - x[None, n_sal:], axis=-1).min(axis=1)
    gaps = []
    for _ in range(picks):
        order = np.argsort(-dist, kind="stable")
        gaps.append(dist[order[0]] - dist[order[1]])
        dist = np.minimum(dist, np.linalg.norm(x[:n_sal] - x[order[0]], axis=-1))
    return gaps


def test_e2e_coreset_embedding_matches_jax(e2e_tree, e2e_weights, tmp_path, monkeypatch):
    """CORESET with EMBEDDING features under SAL, iterations 0 and 1 of
    sample_next_batch in both packages, nothing stubbed: the sweep's
    candidate embeddings, `_embed_labeled`'s center embeddings and their
    assembly into CoreSet's features agree with the JAX package's; the
    greedy picks' distance gaps exceed what that difference can move (four
    times the largest row difference); the guid logs are byte-equal."""
    params, stats = e2e_weights
    cfg = _e2e_configure(get_default_configs(), e2e_tree, str(tmp_path / "port"), "CORESET")
    jcfg = _e2e_configure(jax_configs(), e2e_tree, str(tmp_path / "jax"), "CORESET")
    cfg.AL.CORESET_FEATURES = jcfg.AL.CORESET_FEATURES = "EMBEDDING"
    spies = _CoreSetSpy(port_strategy_mod.coreset_ops), _CoreSetSpy(jax_strategy_mod.coreset_ops)
    monkeypatch.setattr(port_strategy_mod, "coreset_ops", spies[0])
    monkeypatch.setattr(jax_strategy_mod, "coreset_ops", spies[1])
    port = ActiveLearningStrategy(cfg, device="cpu")
    ref = jax_strategy_mod.ActiveLearningStrategy(jcfg)
    pool, jpool = build_dataset(cfg, "train"), jax_build_dataset(jcfg, "train")
    state = from_flax(params, stats)
    jstate = types.SimpleNamespace(params=params, batch_stats=stats)
    for iteration in (0, 1):
        port.sample_next_batch(pool, AL_FRAMES, SAL_FRAMES, state, iteration)
        ref.sample_next_batch(jpool, AL_FRAMES, SAL_FRAMES, jstate, iteration)

    (cs,), (jcs,) = spies[0].built, spies[1].built
    feats, jfeats = cs.features.cpu().numpy(), np.asarray(jcs.features)
    assert cs.n_sal == jcs.n_sal == E2E_FRAMES - AL_FRAMES
    assert feats.shape == jfeats.shape == (E2E_FRAMES, 512)
    scale = float(np.abs(jfeats).max())
    np.testing.assert_allclose(feats, jfeats, rtol=1e-4, atol=1e-4 * scale)
    row_err = float(np.linalg.norm(feats.astype(np.float64) - jfeats, axis=-1).max())
    for step, gap in enumerate(_greedy_gaps(feats, cs.n_sal, AL_FRAMES)):
        assert gap > 4 * row_err, "greedy step %d: gap %g within %g" % (step, gap, 4 * row_err)

    got, want = _read_logs(cfg), _read_logs(jcfg)
    assert sorted(got) == sorted(want) == ["SAL-DICT-ITER-1", "SAL-GUID-ITER-1",
                                          "SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1"]
    sal = json.loads(got["SAL-DICT-ITER-1"])
    al_set = set(json.loads(got["SAMPLED-GUID-ITER-1"]))
    cand = sorted(v for g, v in sal["sal_metric"].items()
                  if g not in al_set and sal["inlier_count"][g] > cfg.SAL.INLIER_THRESHOLD)
    assert len(cand) > 2 * SAL_FRAMES
    _assert_gaps(cand, 2 * SAL_FRAMES, "sal_metric")
    for name in ("SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1", "SAL-GUID-ITER-1"):
        assert got[name] == want[name], name
    _assert_sal_dict_matches(sal, json.loads(want["SAL-DICT-ITER-1"]), E2E_FRAMES - AL_FRAMES)
    assert [f["guid"] for f in pool.labeled_data] == [f["guid"] for f in jpool.labeled_data]


# --------------------------------------------------------------------------
# Selection logic on one shared sal_dict.
# --------------------------------------------------------------------------

POOL, SEL_JOINTS, EMBED = 40, 5, 16


def _frames(rng):
    return {"f%03d" % i: {"guid": "f%03d" % i, "views": {},
                          "3d_keypoints": rng.normal(scale=20.0, size=(SEL_JOINTS, 3)),
                          "joint_valid": np.ones(SEL_JOINTS, bool), "pose": 0, "frame_id": i}
            for i in range(POOL)}


def _shared_sal_dict(rng, guids, nan_poses=(), nan_metrics=(), nan_embeddings=()):
    """Distinct metrics one apart (far beyond any float tolerance), random
    inlier counts and poses, embeddings; NaNs where asked."""
    n = len(guids)
    al = rng.permutation(n).astype(float) + rng.uniform(0, 0.5, n)
    sal = rng.permutation(n).astype(float) + rng.uniform(0, 0.5, n)
    out = {"al_metric": {}, "sal_metric": {}, "inlier_count": {}, "pred_3d_keypoints": {},
           "mkpe": {}, "embedding": {}}
    for i, g in enumerate(guids):
        out["al_metric"][g] = math.nan if g in nan_metrics else float(al[i])
        out["sal_metric"][g] = math.nan if g in nan_metrics else float(sal[i])
        out["inlier_count"][g] = float(rng.integers(2, 6))
        kp = rng.normal(scale=20.0, size=(SEL_JOINTS, 3))
        if g in nan_poses:
            kp[1, 2] = np.nan
        out["pred_3d_keypoints"][g] = kp.tolist()
        out["mkpe"][g] = float(rng.uniform(0, 10))
        emb = rng.normal(size=EMBED).astype(np.float32)
        if g in nan_embeddings:
            emb[3] = np.nan
        out["embedding"][g] = emb
    return out


def _pair(tmp_path, al, expr="SAL", sal=None, layers=18):
    cfgs = []
    for name, make in (("port", get_default_configs), ("jax", jax_configs)):
        cfg = make()
        cfg.DATA.NUM_JOINTS = SEL_JOINTS
        cfg.POSE_ESTIMATOR.NUM_LAYERS = layers
        cfg.TPU.INT8_SCORING = False
        cfg.EXPR_TYPE = expr
        cfg.LOG_DIR = str(tmp_path / name)
        for key, value in al.items():
            setattr(cfg.AL, key, value)
        cfg.SAL.INLIER_THRESHOLD = 2  # of the shared dict's 2 to 5 inliers
        for key, value in (sal or {}).items():
            setattr(cfg.SAL, key, value)
        cfgs.append(cfg)
    return ActiveLearningStrategy(cfgs[0], device="cpu"), jax_strategy_mod.ActiveLearningStrategy(
        cfgs[1])


SELECTION_CASES = {
    "MPE_AL": (dict(STRATEGY="MPE"), "AL", None, {}),
    "MPE_SAL": (dict(STRATEGY="MPE"), "SAL", None, {}),
    "HP_SAL": (dict(STRATEGY="HP"), "SAL", None, {}),
    "BSB_SAL": (dict(STRATEGY="BSB"), "SAL", None, {"nan_metrics": ("f004", "f017")}),
    "TRIANGULATION_INLIER_THRESHOLD_4": (dict(STRATEGY="TRIANGULATION"), "SAL",
                                         dict(INLIER_THRESHOLD=4), {}),
    "TRIANGULATION_INLIER_THRESHOLD_0": (dict(STRATEGY="TRIANGULATION"), "SAL",
                                         dict(INLIER_THRESHOLD=0), {}),
    "CORESET_POSE": (dict(STRATEGY="CORESET"), "SAL", None,
                     {"nan_poses": ("f003", "f020", "f031")}),
    "CORESET_EMBEDDING": (dict(STRATEGY="CORESET", CORESET_FEATURES="EMBEDDING"), "SAL", None,
                          {"nan_poses": ("f020",), "nan_embeddings": ("f003", "f011", "f035")}),
    "RANDOM_AL": (dict(STRATEGY="RANDOM"), "AL", None, {}),
    "CLUSTER_QUOTA": (dict(STRATEGY="TRIANGULATION"), "SAL", "cluster", {}),
    "OVERDRAW": (dict(STRATEGY="HP"), "SAL", None, {}),
}


@pytest.mark.parametrize("case", sorted(SELECTION_CASES))
def test_selection_matches_jax(case, tmp_path):
    al, expr, sal, nans = SELECTION_CASES[case]
    rng = np.random.default_rng(11 + sorted(SELECTION_CASES).index(case))
    frames = _frames(rng)
    if sal == "cluster":
        clusters = {g: rng.normal(scale=20.0, size=(SEL_JOINTS, 3)).tolist() for g in list(frames)[:20]}
        path = tmp_path / "clusters.json"
        path.write_text(json.dumps(clusters))
        sal = dict(CLUSTER_FILE_PATH=str(path), NUM_CLUSTERS=3)
    port, ref = _pair(tmp_path, al, expr, sal)
    pool, jpool = FramePool(copy.deepcopy(frames)), JaxFramePool(copy.deepcopy(frames))
    labeled = ["f%03d" % i for i in (1, 7, 12, 30)]
    for p in (pool, jpool):
        p.label_by_frame_guids(labeled)
        p.pseudo_label_by_frame_guids(["f005"], {"f005": frames["f005"]["3d_keypoints"]})
    unlabeled = list(pool.unlabeled_data)
    shared = _shared_sal_dict(rng, unlabeled, **nans)
    if al.get("CORESET_FEATURES") != "EMBEDDING":
        del shared["embedding"]
    lab_emb = {g: rng.normal(size=EMBED).astype(np.float32) for g in labeled}
    lab_emb["f007"][0] = np.nan
    for s in (port, ref):
        s._compute_sal_dict = lambda *a, **k: copy.deepcopy(shared)
        s._embed_labeled = lambda *a, **k: copy.deepcopy(lab_emb)
    al_frames = POOL + 5 if case == "OVERDRAW" else 6
    got = port._sal_pseudo_labeling(pool, al_frames, 4, None, 3)
    want = ref._sal_pseudo_labeling(jpool, al_frames, 4, None, 3)
    assert got[0] == want[0]
    assert got[1] == want[1]
    if case in ("OVERDRAW",):
        assert len(got[0]) == POOL - len(labeled) and not got[1]
    elif expr == "SAL" and case != "TRIANGULATION_INLIER_THRESHOLD_4":
        assert got[1], "no SAL guids: the case checks nothing"
    assert [f["guid"] for f in pool.labeled_data] == [f["guid"] for f in jpool.labeled_data]
    assert pool.pseudo_label_guids == jpool.pseudo_label_guids
    assert list(pool.unlabeled_data) == list(jpool.unlabeled_data)
