"""The port's Engine against the JAX Engine: score_step (TRIANGULATION,
CORESET with POSE and EMBEDDING features, RANDOM, MPE / HP / BSB with AVG
and STD, AL.DIRECT_OPTIMIZATION), eval_step, embed_step and loss_step on
the same weights (carried by from_flax), frames, cameras and pairs.
ResNet-18 (and a narrow HRNet, float and int8), 64x64 crops, B=2, V=5, K=4,
TPU.INT8_SCORING=False unless stated.

Tolerances in float32: inlier_count exact; keypoints_3d atol=1e-2 on a
~100-unit scene; sal_metric / al_metric rtol=1e-4, atol=1e-3 (pixels); mkpe
atol=1e-2.  Heatmaps agree to 1e-4 of their scale (as the model tests), so
the decoded argmaxes are identical and only the float32 sums of the
triangulation differ in order.

bfloat16: the heatmaps are compared, max error <= 0.05 of their scale and
cosine > 0.999 -- both frameworks round the activations to 8 mantissa bits
at every layer, in other places, so argmaxes of near-equal peaks may flip
and the triangulated outputs are checked for shape and finiteness only.

Int8 scoring (TPU.INT8_SCORING, the default): the heatmaps of the port's
and the JAX engine's int8 score_step on the same calibrated scales agree to
cosine > 0.999 and per-map argmax agreement >= 0.95 (models/quantize.py's
bar, tests/test_torch_quantize.py).  The calibrated tables have the same
keys and each scale is within one bf16 step (2^-7 relative): a scale is the
max of a bf16 activation, and one element of it may round one step apart
(measured: one key of 20 off, by 2^-7.8; the normalized frames are equal).
The TPU.PALLAS_HEAD forward against the JAX trunk + head in interpret
mode, float32: max error <= 1e-4 of the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import golden_fill_values, make_ring_cameras
from multi_view_active_learning_tpu.config import get_default_configs as jax_default_configs
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.ops.pallas import deconv as jax_deconv
from multi_view_active_learning_tpu_torch import engine as torch_engine
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.engine import Engine
from multi_view_active_learning_tpu_torch.models.convert import from_flax
from multi_view_active_learning_tpu_torch.utils import prng

B, V, K, IMG = 2, 5, 4, 64


def _configure(cfg, dtype, **tpu):
    cfg.DATA.NUM_JOINTS = K
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = IMG
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.INT8_SCORING = False
    for key, value in tpu.items():
        setattr(cfg.TPU, key, value)
    return cfg


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(B, V, IMG, IMG, 3)).astype(np.uint8)
    proj = np.ascontiguousarray(np.broadcast_to(
        make_ring_cameras(V, img=IMG, focal=65.0), (B, V, 3, 4))).astype(np.float32)
    valid = np.ones((B, K), bool)
    valid[1, 2] = False
    gt = rng.normal(scale=20.0, size=(B, K, 3)).astype(np.float32)
    return images, proj, valid, gt


@pytest.fixture(scope="module")
def weights():
    """Flax (params, batch_stats) with O(1) activations, from seeded numpy."""
    jax_engine = JaxEngine(_configure(jax_default_configs(), "float32"))
    shapes = jax.eval_shape(lambda: jax_engine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3)))
    zeros = jax_convert.flax_to_torch_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.params),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.batch_stats),
        "POSE_RESNET",
    )
    values = golden_fill_values(list(zeros), [a.shape for a in zeros.values()], 5)
    return jax_convert.torch_state_dict_to_flax(values, "POSE_RESNET")


def _engines(weights, dtype, **tpu):
    params, stats = weights
    jax_engine = JaxEngine(_configure(jax_default_configs(), dtype, **tpu))
    port = Engine(_configure(get_default_configs(), dtype, **tpu), device="cpu")
    port.load_state_dict(from_flax(params, stats))
    return jax_engine, port


@pytest.fixture(scope="module")
def float32_runs(weights):
    """Both engines' outputs on the same inputs, float32."""
    params, stats = weights
    jax_engine, port = _engines(weights, "float32")
    images, proj, valid, gt = _inputs()
    pairs = jax_engine.pairs(V)
    args = [jnp.asarray(a) for a in (images, proj, valid, pairs, gt)]
    out = {"jax": {}, "port": {}}
    for strategy in ("TRIANGULATION", "CORESET"):
        ref = jax_engine.score_step(params, stats, *args, jax.random.PRNGKey(0),
                                    al_strategy=strategy)
        out["jax"][strategy] = {k: np.asarray(v) for k, v in ref.items()}
        got = port.score_step(images, proj, valid, pairs, gt, al_strategy=strategy)
        out["port"][strategy] = {k: v.numpy() for k, v in got.items()}
    ref = jax_engine.eval_step(params, stats, args[0], args[1], args[2], args[3])
    out["jax"]["eval"] = {k: np.asarray(v) for k, v in ref.items()}
    got = port.eval_step(images, proj, valid, pairs)
    out["port"]["eval"] = {k: v.numpy() for k, v in got.items()}
    out["jax"]["heatmaps"] = np.asarray(
        jax_engine.forward(params, stats, args[0], use_int8=False)).transpose(0, 1, 4, 2, 3)
    out["port"]["heatmaps"] = port.forward(images).numpy()
    return out


def test_forward_matches_jax(float32_runs):
    ref, got = float32_runs["jax"]["heatmaps"], float32_runs["port"]["heatmaps"]
    assert got.shape == (B, V, K, IMG // 4, IMG // 4) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("strategy", ["TRIANGULATION", "CORESET"])
def test_score_step_matches_jax(float32_runs, strategy):
    ref, got = float32_runs["jax"][strategy], float32_runs["port"][strategy]
    assert set(got) == {"keypoints_3d", "sal_metric", "inlier_count", "al_metric", "mkpe"}
    np.testing.assert_array_equal(got["inlier_count"], ref["inlier_count"])
    np.testing.assert_allclose(got["keypoints_3d"], ref["keypoints_3d"], atol=1e-2)
    np.testing.assert_allclose(got["sal_metric"], ref["sal_metric"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["al_metric"], ref["al_metric"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["mkpe"], ref["mkpe"], atol=1e-2)
    assert (got["keypoints_3d"][1, 2] == 0).all()  # invalid joint zeroed


def test_eval_step_matches_jax(float32_runs):
    ref, got = float32_runs["jax"]["eval"], float32_runs["port"]["eval"]
    np.testing.assert_allclose(got["keypoints_3d"], ref["keypoints_3d"], atol=1e-2)


def test_eval_step_decodes_by_hard_argmax(weights):
    port = Engine(_configure(get_default_configs(), "float32"), device="cpu")
    port.load_state_dict(from_flax(*weights))
    soft = _configure(get_default_configs(), "float32")
    soft.AL.USE_SOFTARGMAX = True
    port_soft = Engine(soft, device="cpu")
    port_soft.load_state_dict(from_flax(*weights))
    images, proj, valid, gt = _inputs()
    pairs = port.pairs(V)
    torch.testing.assert_close(port.eval_step(images, proj, valid, pairs)["keypoints_3d"],
                               port_soft.eval_step(images, proj, valid, pairs)["keypoints_3d"])


def test_bfloat16_close_to_jax(weights):
    params, stats = weights
    jax_engine, port = _engines(weights, "bfloat16")
    images, proj, valid, gt = _inputs()
    ref = np.asarray(jax_engine.forward(params, stats, jnp.asarray(images), use_int8=False))
    got = port.forward(images).numpy()
    ref = ref.transpose(0, 1, 4, 2, 3)
    assert got.dtype == np.float32
    scale = np.abs(ref).max()
    cos = float(np.dot(got.ravel(), ref.ravel()) / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert np.abs(got - ref).max() <= 0.05 * scale and cos > 0.999, (np.abs(got - ref).max(), cos)
    out = port.score_step(images, proj, valid, port.pairs(V), gt)
    assert out["keypoints_3d"].shape == (B, K, 3)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_random_strategy_shape_range_and_seed(weights):
    """RANDOM draws jax.random.uniform(key, (B,)) bit for bit from the
    port's threefry key, repeats for the same key, and needs a key."""
    port = Engine(_configure(get_default_configs(), "float32"), device="cpu")
    port.load_state_dict(from_flax(*weights))
    images, proj, valid, gt = _inputs()
    pairs = port.pairs(V)
    draws = [
        port.score_step(images, proj, valid, pairs, gt, al_strategy="RANDOM",
                        key=prng.PRNGKey(3))["al_metric"]
        for _ in range(2)
    ]
    assert draws[0].shape == (B,) and ((draws[0] >= 0) & (draws[0] < 1)).all()
    torch.testing.assert_close(draws[0], draws[1])
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (B,)))
    np.testing.assert_array_equal(draws[0].numpy().view(np.uint32), ref.view(np.uint32))
    with pytest.raises(ValueError):
        port.score_step(images, proj, valid, pairs, gt, al_strategy="RANDOM")


def test_pairs_match_jax():
    jax_engine = JaxEngine(_configure(jax_default_configs(), "float32"))
    port = Engine(_configure(get_default_configs(), "float32"), device="cpu")
    for views in (31, 8, 5):
        np.testing.assert_array_equal(port.pairs(views), jax_engine.pairs(views))
    assert len(port.pairs(31)) == 64


UNPORTED = [(key, value) for key, value, _ in torch_engine._UNPORTED] + [
    ("TPU.VIEW_AXIS", 2), ("TPU.HRNET_PACKED_MAX_CH", 32)]


@pytest.mark.parametrize("key,value", UNPORTED, ids=["%s=%s" % kv for kv in UNPORTED])
def test_unported_option_raises(key, value):
    cfg = _configure(get_default_configs(), "float32")
    node = cfg
    *path, leaf = key.split(".")
    for part in path:
        node = getattr(node, part)
    setattr(node, leaf, value)
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        Engine(cfg, device="cpu")


def test_use_pallas_false_is_accepted(weights):
    """TPU.USE_PALLAS=False builds, and scores the default's keypoints: the
    JAX package's XLA decode gives the kernel's values, so the port decodes
    through K1 either way."""
    images, proj, valid, gt = _inputs()
    outs = []
    for use_pallas in (True, False):
        port = Engine(_configure(get_default_configs(), "float32", USE_PALLAS=use_pallas),
                      device="cpu")
        port.load_state_dict(from_flax(*weights))
        outs.append(port.score_step(images, proj, valid, port.pairs(V), gt))
    for key in outs[0]:
        torch.testing.assert_close(outs[1][key], outs[0][key], rtol=0, atol=0)


def test_default_config_raises_on_int8_scoring():
    """The default configuration now scores int8; what int8 scoring does not
    take yet still raises: the space-to-depth stem (ROADMAP Queue A12)."""
    assert Engine(get_default_configs(), device="cpu").use_int8
    cfg = get_default_configs()
    cfg.TPU.SPACE_TO_DEPTH_STEM = True
    with pytest.raises(NotImplementedError, match="SPACE_TO_DEPTH_STEM"):
        Engine(cfg, device="cpu")


def test_default_config_scores_through_int8_backbone():
    engine = Engine(get_default_configs(), device="cpu")  # PoseResNet-50, 19 joints
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(1, 3, IMG, IMG, 3)).astype(np.uint8)
    proj = make_ring_cameras(3, img=IMG, focal=65.0)[None].astype(np.float32)
    valid, gt = np.ones((1, 19), bool), np.zeros((1, 19, 3), np.float32)
    out = engine.score_step(images, proj, valid, engine.pairs(3), gt, al_strategy="TRIANGULATION")
    assert out["keypoints_3d"].shape == (1, 19, 3)
    assert all(torch.isfinite(v).all() for v in out.values())
    int8, flt = engine.forward(images), engine.forward(images, use_int8=False)
    assert not torch.equal(int8, flt)  # the int8 backbone ran, not the float model
    cos = float(torch.dot(int8.ravel(), flt.ravel()) / (int8.norm() * flt.norm()))
    assert cos > 0.99, cos


def _cfg_with(**changes):
    cfg = get_default_configs()
    for key, value in changes.items():
        section, leaf = key.split("__")
        setattr(getattr(cfg, section), leaf, value)
    return cfg


@pytest.mark.parametrize("strategy,force,expected", [
    ("TRIANGULATION", False, True), ("HP", False, True), ("CORESET", False, True),
    ("RANDOM", False, True), ("MPE", False, False), ("BSB", False, False),
    ("MPE", True, True), ("BSB", True, True),
])
def test_int8_gate_per_strategy(strategy, force, expected):
    """After tests/test_quantize.py:244-280: int8 only for the strategies
    measured int8-safe, unless TPU.INT8_SCORING_FORCE."""
    cfg = _cfg_with(AL__STRATEGY=strategy, TPU__INT8_SCORING_FORCE=force)
    assert torch_engine.use_int8(cfg) is expected
    assert (strategy in torch_engine.INT8_SAFE_STRATEGIES) is (strategy not in ("MPE", "BSB"))


def test_int8_gate_coreset_embedding_and_master_switch():
    assert not torch_engine.use_int8(_cfg_with(AL__STRATEGY="CORESET", AL__CORESET_FEATURES="EMBEDDING"))
    assert torch_engine.use_int8(_cfg_with(AL__STRATEGY="CORESET", AL__CORESET_FEATURES="EMBEDDING",
                                           TPU__INT8_SCORING_FORCE=True))
    assert not torch_engine.use_int8(_cfg_with(TPU__INT8_SCORING=False))
    assert not torch_engine.use_int8_eval(get_default_configs())
    assert torch_engine.use_int8_eval(_cfg_with(TPU__INT8_EVAL=True))


def test_int8_gate_per_model_family():
    """After tests/test_quantize.py:210-230: PoseResNet on by default, HRNet
    only with TPU.INT8_SCORING_HRNET, the master switch wins."""
    assert torch_engine.use_int8(get_default_configs())
    hrnet = _cfg_with(POSE_ESTIMATOR__TYPE="HRNET")
    assert not torch_engine.use_int8(hrnet)
    hrnet.TPU.INT8_SCORING_HRNET = True
    assert torch_engine.use_int8(hrnet)
    hrnet.TPU.INT8_SCORING = False
    assert not torch_engine.use_int8(hrnet)


def test_int8_float_tail():
    assert torch_engine.int8_float_tail(_cfg_with(TPU__INT8_FLOAT_TAIL_STAGES=2)) == 2
    assert torch_engine.INT8_MIXED_TAIL == {}


@pytest.fixture(scope="module")
def int8_runs(weights):
    """Both engines' int8 score_step (float32 compute, so the normalized
    frames are equal before the int8 forward's bf16 cast) on scales each
    calibrated on the frames, and their heatmaps."""
    params, stats = weights
    jax_engine, port = _engines(weights, "float32", INT8_SCORING=True)
    assert jax_engine.use_int8 and port.use_int8
    images, proj, valid, gt = _inputs()
    pairs = jax_engine.pairs(V)
    args = [jnp.asarray(a) for a in (images, proj, valid, pairs, gt)]
    jax_scales = jax_engine.int8_calibrate(params, stats, args[0])
    port_scales = port.int8_calibrate(images)
    ref = jax_engine.score_step(params, stats, *args, jax.random.PRNGKey(0), int8_scales=jax_scales)
    got = port.score_step(images, proj, valid, pairs, gt, int8_scales=port_scales)
    heat_ref = np.asarray(jax_engine.forward(params, stats, args[0], jax_scales)).transpose(0, 1, 4, 2, 3)
    return dict(jax={k: np.asarray(v) for k, v in ref.items()}, port={k: v.numpy() for k, v in got.items()},
                jax_scales={k: np.asarray(v) for k, v in jax_scales.items()}, port_scales=port_scales,
                heat_ref=heat_ref, heat=port.forward(images, port_scales).numpy())


def test_int8_calibration_matches_jax(int8_runs):
    ref, got = int8_runs["jax_scales"], int8_runs["port_scales"]
    assert set(got) == set(ref) and "stem" in got
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=2.0**-7)
    assert sum(float(got[n]) != float(ref[n]) for n in ref) <= 2


def test_int8_score_step_matches_jax(int8_runs):
    """Heatmaps: measured cosine 0.99993 and agreement 0.975 (one map of
    40 decodes to another pixel).  Where every view of a joint decodes to
    the same pixels, its keypoint agrees as in float32, and so do the
    per-frame outputs of frames whose joints all agree."""
    got, ref = int8_runs["heat"], int8_runs["heat_ref"]
    cos = float(np.dot(got.ravel(), ref.ravel()) / (np.linalg.norm(got) * np.linalg.norm(ref)))
    same = got.reshape(B, V, K, -1).argmax(-1) == ref.reshape(B, V, K, -1).argmax(-1)
    assert cos > 0.999 and same.mean() >= 0.95, (cos, same.mean())
    joint_ok = same.all(axis=1)  # [B, K]
    frame_ok = joint_ok.all(axis=1)  # [B]
    assert frame_ok.any()
    ref, got = int8_runs["jax"], int8_runs["port"]
    assert set(got) == {"keypoints_3d", "sal_metric", "inlier_count", "al_metric", "mkpe"}
    assert joint_ok.sum() >= B * K - 1
    np.testing.assert_allclose(got["keypoints_3d"][joint_ok], ref["keypoints_3d"][joint_ok], atol=1e-2)
    np.testing.assert_array_equal(got["inlier_count"][frame_ok], ref["inlier_count"][frame_ok])
    np.testing.assert_allclose(got["sal_metric"][frame_ok], ref["sal_metric"][frame_ok],
                               rtol=1e-4, atol=1e-3)
    assert all(np.isfinite(v).all() for v in got.values())


def test_pallas_head_forward_matches_jax(weights):
    """TPU.PALLAS_HEAD: the port's trunk + K3 head (plain version on the CPU)
    against the JAX trunk + apply_pose_resnet_head in interpret mode (the
    JAX engine itself takes the fused head only on a TPU)."""
    params, stats = weights
    jax_engine, port = _engines(weights, "float32", PALLAS_HEAD=True)
    assert port.use_pallas_head
    images = _inputs()[0]
    flat = jax_engine._flatten_normalize(jnp.asarray(images))
    trunk = jax_engine.model.apply({"params": params, "batch_stats": stats}, flat, train=False,
                                   skip_head=True)
    ref = np.asarray(jax_deconv.apply_pose_resnet_head(trunk, params, stats, interpret=True))
    ref = ref.reshape((B, V) + ref.shape[1:]).transpose(0, 1, 4, 2, 3)
    got = port.forward(images).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_int8_calibrate_returns_none_when_off(weights):
    _, port = _engines(weights, "float32")
    assert port.int8_calibrate(_inputs()[0]) is None
    assert port.int8_calibrate(_inputs()[0], for_eval=True) is None


def test_int8_eval_step(weights):
    """TPU.INT8_EVAL opts eval into the int8 backbone; scoring stays float."""
    _, port = _engines(weights, "float32", INT8_EVAL=True)
    assert port.use_int8_eval and not port.use_int8
    images, proj, valid, _ = _inputs()
    scales = port.int8_calibrate(images, for_eval=True)
    assert scales is not None and port.int8_calibrate(images) is None
    out = port.eval_step(images, proj, valid, port.pairs(V), int8_scales=scales)
    assert out["keypoints_3d"].shape == (B, K, 3) and torch.isfinite(out["keypoints_3d"]).all()


def test_load_state_dict_requantizes(weights):
    _, port = _engines(weights, "float32", INT8_SCORING=True, INT8_DECONV=True)
    first = {k: v.clone() for k, v in port._int8_weights.items() if torch.is_tensor(v)}
    assert first["deconv_layers.0.wq"].dtype == torch.int8
    state = from_flax(*weights)
    state = {k: v * 0.5 if k.endswith(".weight") else v for k, v in state.items()}
    port.load_state_dict(state)
    now = port._int8_weights
    assert torch.equal(now["conv1.ws"], first["conv1.ws"] * 0.5)
    assert torch.equal(now["conv1.wq"], first["conv1.wq"])  # scale-invariant
    assert torch.equal(now["deconv_layers.0.ws"], first["deconv_layers.0.ws"] * 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepacked_head_operands_equal_per_call_packing(weights, dtype):
    """The K3 operands the engine packs at load, and the K4 operands of
    quantize_state_dict, equal what the per-call wrappers pack, and are
    packed again when new weights load."""
    from multi_view_active_learning_tpu_torch.kernels import deconv

    _, port = _engines(weights, dtype, PALLAS_HEAD=True, INT8_SCORING=True, INT8_DECONV=True)
    for i, ops in enumerate(port._k3_heads):
        conv, bn = port.model.deconv_layers[3 * i], port.model.deconv_layers[3 * i + 1]
        fresh = deconv.pack_k3(conv.weight, *deconv.fold_bn(
            bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps), port.dtype)
        assert ops.wpk.dtype == port.dtype
        for got, ref in zip(ops, fresh):
            assert torch.equal(got, ref)
    qp = port._int8_weights
    for i in range(3):
        conv, bn = "deconv_layers.%d" % (3 * i), "deconv_layers.%d" % (3 * i + 1)
        fresh = deconv.pack_k4(qp[conv + ".wq"], qp[conv + ".ws"], qp[bn + ".scale"], qp[bn + ".bias"])
        assert torch.equal(qp[conv + ".wpk"], fresh.wpk)
    state = {k: v * 0.5 if k.endswith(".weight") else v for k, v in from_flax(*weights).items()}
    port.load_state_dict(state)
    w0 = port.model.deconv_layers[0].weight
    assert torch.equal(port._k3_heads[0].wpk, deconv.pack_weight(w0.to(port.dtype)))


def test_unported_strategy_raises_in_score_step():
    """Every strategy of the JAX engine is ported; an unknown one raises,
    as the JAX engine's does."""
    port = Engine(_configure(get_default_configs(), "float32"), device="cpu")
    images, proj, valid, gt = _inputs()
    assert set(torch_engine.SCORING_STRATEGIES) == {
        "TRIANGULATION", "RANDOM", "CORESET", "MPE", "HP", "BSB"}
    with pytest.raises(NotImplementedError, match="Unknown AL strategy: ENTROPY"):
        port.score_step(images, proj, valid, port.pairs(V), gt, al_strategy="ENTROPY")


def test_no_device_means_cuda_or_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(_configure(get_default_configs(), "float32"))
    from multi_view_active_learning_tpu_torch.ops import coreset

    with pytest.raises(RuntimeError, match="CUDA"):
        coreset.CoreSet({"a": np.zeros((K, 3))}, {}, 0)


# -- the uncertainty strategies, EMBEDDING, loss_step, direct optimization ----
#
# Tolerances: the float32 heatmaps of the two engines agree to 1e-4 of their
# scale (test_forward_matches_jax), so peak sets and argmaxes are the same
# and MPE / HP / BSB differ only by float32 sums in another order: rtol 1e-4
# and atol 1e-5.  Embeddings (pooled trunk features) rtol 1e-4 of their
# scale; loss_step rtol 1e-4.

UNCERTAINTY = [(s, a) for s in ("MPE", "HP", "BSB") for a in ("AVG", "STD")]


@pytest.fixture(scope="module")
def uncertainty_runs(weights):
    params, stats = weights
    jax_engine, port = _engines(weights, "float32")
    images, proj, valid, gt = _inputs()
    pairs = jax_engine.pairs(V)
    args = [jnp.asarray(a) for a in (images, proj, valid, pairs, gt)]
    out = {}
    for strategy, aggregate in UNCERTAINTY:
        kw = {"%s_aggregate" % strategy.lower(): aggregate}
        ref = jax_engine.score_step(params, stats, *args, jax.random.PRNGKey(0),
                                    al_strategy=strategy, **kw)
        got = port.score_step(images, proj, valid, pairs, gt, al_strategy=strategy, **kw)
        out[(strategy, aggregate)] = ({k: np.asarray(v) for k, v in ref.items()},
                                      {k: v.numpy() for k, v in got.items()})
    return out


@pytest.mark.parametrize("strategy,aggregate", UNCERTAINTY, ids=["%s-%s" % u for u in UNCERTAINTY])
def test_uncertainty_score_step_matches_jax(uncertainty_runs, strategy, aggregate):
    ref, got = uncertainty_runs[(strategy, aggregate)]
    assert set(got) == set(ref) == {"keypoints_3d", "sal_metric", "inlier_count", "al_metric", "mkpe"}
    np.testing.assert_allclose(got["al_metric"], ref["al_metric"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["inlier_count"], ref["inlier_count"])
    np.testing.assert_allclose(got["keypoints_3d"], ref["keypoints_3d"], atol=1e-2)
    assert (got["al_metric"] > 0).all()


def test_uncertainty_aggregates_differ_and_unknown_raises(uncertainty_runs, weights):
    for strategy in ("MPE", "HP", "BSB"):
        avg = uncertainty_runs[(strategy, "AVG")][1]["al_metric"]
        std = uncertainty_runs[(strategy, "STD")][1]["al_metric"]
        assert not np.allclose(avg, std)
    _, port = _engines(weights, "float32")
    images, proj, valid, gt = _inputs()
    with pytest.raises(ValueError, match="AVG or STD"):
        port.score_step(images, proj, valid, port.pairs(V), gt, al_strategy="HP",
                        hp_aggregate="MAX")


def _embedding_engines(weights, **tpu):
    params, stats = weights
    jcfg = _configure(jax_default_configs(), "float32", **tpu)
    pcfg = _configure(get_default_configs(), "float32", **tpu)
    for cfg in (jcfg, pcfg):
        cfg.AL.STRATEGY = "CORESET"
        cfg.AL.CORESET_FEATURES = "EMBEDDING"
    port = Engine(pcfg, device="cpu")
    port.load_state_dict(from_flax(params, stats))
    return JaxEngine(jcfg), port


def test_coreset_embedding_and_embed_step_match_jax(weights):
    params, stats = weights
    jax_engine, port = _embedding_engines(weights)
    assert not port.use_int8
    images, proj, valid, gt = _inputs()
    pairs = jax_engine.pairs(V)
    args = [jnp.asarray(a) for a in (images, proj, valid, pairs, gt)]
    ref = jax_engine.score_step(params, stats, *args, jax.random.PRNGKey(0), al_strategy="CORESET")
    got = port.score_step(images, proj, valid, pairs, gt, al_strategy="CORESET")
    assert set(got) == set(ref) and "embedding" in got
    emb, ref_emb = got["embedding"].numpy(), np.asarray(ref["embedding"])
    assert emb.shape == (B, 512) and emb.dtype == np.float32
    assert np.abs(emb - ref_emb).max() <= 1e-4 * np.abs(ref_emb).max()
    np.testing.assert_array_equal(got["inlier_count"].numpy(), np.asarray(ref["inlier_count"]))
    embedded = port.embed_step(images)
    torch.testing.assert_close(embedded, got["embedding"], rtol=0, atol=0)  # one function
    ref_embedded = np.asarray(jax_engine.embed_step(params, stats, args[0]))
    assert np.abs(embedded.numpy() - ref_embedded).max() <= 1e-4 * np.abs(ref_embedded).max()


def test_embedding_path_is_the_float_model_whatever_the_options(weights):
    """INT8_SCORING_FORCE and PALLAS_HEAD change the heatmap forward, never
    the EMBEDDING features (JAX engine.py:550-567)."""
    _, plain = _embedding_engines(weights)
    _, forced = _embedding_engines(weights, INT8_SCORING=True, INT8_SCORING_FORCE=True,
                                   PALLAS_HEAD=True)
    assert forced.use_int8 and forced.use_pallas_head
    images, proj, valid, gt = _inputs()
    a = plain.score_step(images, proj, valid, plain.pairs(V), gt, al_strategy="CORESET")
    b = forced.score_step(images, proj, valid, forced.pairs(V), gt, al_strategy="CORESET")
    torch.testing.assert_close(a["embedding"], b["embedding"], rtol=0, atol=0)
    torch.testing.assert_close(a["keypoints_3d"], b["keypoints_3d"], rtol=0, atol=0)
    assert not torch.equal(forced.forward(images), plain.forward(images))  # int8 elsewhere


def test_loss_step_matches_jax(weights):
    params, stats = weights
    jax_engine, port = _engines(weights, "float32", INT8_SCORING=True)
    images = _inputs()[0]
    gt = np.random.default_rng(6).random((B, V, K, IMG // 4, IMG // 4)).astype(np.float32)
    got = port.loss_step(images, gt).numpy()
    ref = np.asarray(jax_engine.loss_step(params, stats, jnp.asarray(images),
                                          jnp.asarray(gt.transpose(0, 1, 3, 4, 2))))
    assert got.shape == (B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    heat = port.forward(images, use_int8=False).numpy()  # float, though int8 scoring is on
    np.testing.assert_allclose(got, ((heat - gt) ** 2).sum(axis=(1, 2, 3, 4)) / (IMG // 4) ** 2,
                               rtol=1e-5)


def test_direct_optimization_matches_jax(weights):
    """AL.DIRECT_OPTIMIZATION: TRIANGULATION scoring with the Huber refine;
    eval_step ignores the option, as the JAX engine's does.  The metric at
    the float32 bounds of test_score_step_matches_jax; keypoints atol 5e-2
    (tests/test_torch_triangulate.py's refine bound) for points inside the
    rig.  The random-weight net's inconsistent decodes put one joint about
    7,000 units out, where the Huber cost is flat along the viewing ray:
    there both packages reach the same reprojection error (27.83) about 55
    units apart, so only its error is compared."""
    params, stats = weights
    jcfg = _configure(jax_default_configs(), "float32")
    pcfg = _configure(get_default_configs(), "float32")
    jcfg.AL.DIRECT_OPTIMIZATION = pcfg.AL.DIRECT_OPTIMIZATION = True
    jax_engine, port = JaxEngine(jcfg), Engine(pcfg, device="cpu")
    port.load_state_dict(from_flax(params, stats))
    _, plain = _engines(weights, "float32")
    images, proj, valid, gt = _inputs()
    pairs = jax_engine.pairs(V)
    args = [jnp.asarray(a) for a in (images, proj, valid, pairs, gt)]
    ref = jax_engine.score_step(params, stats, *args, jax.random.PRNGKey(0))
    got = port.score_step(images, proj, valid, pairs, gt)
    np.testing.assert_array_equal(got["inlier_count"].numpy(), np.asarray(ref["inlier_count"]))
    kp, ref_kp = got["keypoints_3d"].numpy(), np.asarray(ref["keypoints_3d"])
    inside = np.linalg.norm(ref_kp, axis=-1) < 1000.0
    assert inside.sum() >= B * K - 2
    np.testing.assert_allclose(kp[inside], ref_kp[inside], atol=5e-2)
    np.testing.assert_allclose(got["sal_metric"].numpy(), np.asarray(ref["sal_metric"]),
                               rtol=1e-4, atol=1e-3)
    unrefined = plain.score_step(images, proj, valid, pairs, gt)
    assert not torch.equal(got["keypoints_3d"], unrefined["keypoints_3d"])
    torch.testing.assert_close(port.eval_step(images, proj, valid, pairs)["keypoints_3d"],
                               plain.eval_step(images, proj, valid, pairs)["keypoints_3d"])


# -- an HRNet engine: float (MPE, the slice as a whole) and int8 --------------

HRNET_STAGES = {"STAGE2": ([1, 1], [8, 16]), "STAGE3": ([1, 1, 1], [8, 16, 32]),
                "STAGE4": ([1, 1, 1, 1], [8, 16, 32, 64])}


def _configure_hrnet(cfg, dtype, **tpu):
    _configure(cfg, dtype, **tpu)
    cfg.POSE_ESTIMATOR.TYPE = "HRNET"
    for name, (blocks, channels) in HRNET_STAGES.items():
        stage = getattr(cfg.POSE_ESTIMATOR.HRNET, name)
        stage.NUM_MODULES, stage.NUM_BLOCKS, stage.NUM_CHANNELS = 1, blocks, channels
    return cfg


@pytest.fixture(scope="module")
def hrnet_weights():
    jax_engine = JaxEngine(_configure_hrnet(jax_default_configs(), "float32"))
    shapes = jax.eval_shape(lambda: jax_engine.init_state(jax.random.PRNGKey(0), (1, IMG, IMG, 3)))
    zeros = jax_convert.flax_to_torch_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.params),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes.batch_stats),
        "HRNET")
    values = golden_fill_values(list(zeros), [a.shape for a in zeros.values()], 9)
    return jax_convert.torch_state_dict_to_flax(values, "HRNET")


def _hrnet_engines(hrnet_weights, **tpu):
    params, stats = hrnet_weights
    jax_engine = JaxEngine(_configure_hrnet(jax_default_configs(), "float32", **tpu))
    port = Engine(_configure_hrnet(get_default_configs(), "float32", **tpu), device="cpu")
    port.load_state_dict(from_flax(params, stats, "HRNET"))
    return jax_engine, port


def test_hrnet_engine_scores_mpe_like_jax(hrnet_weights):
    """The slice as a whole: a narrow HRNet engine, uint8 frames -> HRNet
    forward -> K1 decode -> RANSAC -> MPE, against the JAX engine."""
    params, stats = hrnet_weights
    jax_engine, port = _hrnet_engines(hrnet_weights)
    assert not port.use_int8
    images, proj, valid, gt = _inputs()
    pairs = jax_engine.pairs(V)
    args = [jnp.asarray(a) for a in (images, proj, valid, pairs, gt)]
    heat_ref = np.asarray(jax_engine.forward(params, stats, args[0], use_int8=False))
    heat = port.forward(images).numpy()
    assert heat.shape == (B, V, K, IMG // 4, IMG // 4)
    assert np.abs(heat - heat_ref.transpose(0, 1, 4, 2, 3)).max() <= 1e-4 * np.abs(heat_ref).max()
    ref = jax_engine.score_step(params, stats, *args, jax.random.PRNGKey(0), al_strategy="MPE")
    got = port.score_step(images, proj, valid, pairs, gt, al_strategy="MPE")
    np.testing.assert_allclose(got["al_metric"].numpy(), np.asarray(ref["al_metric"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["inlier_count"].numpy(), np.asarray(ref["inlier_count"]))
    np.testing.assert_allclose(got["keypoints_3d"].numpy(), np.asarray(ref["keypoints_3d"]), atol=1e-2)
    np.testing.assert_allclose(got["mkpe"].numpy(), np.asarray(ref["mkpe"]), atol=1e-2)


def test_hrnet_engine_int8_matches_jax(hrnet_weights):
    """TPU.INT8_SCORING_HRNET: both engines' int8 forwards on scales each
    calibrated on the frames, at the int8 bars of test_int8_score_step_matches_jax
    (cosine > 0.999, argmax agreement >= 0.95) and the JAX bar against float
    (cosine > 0.99)."""
    params, stats = hrnet_weights
    jax_engine, port = _hrnet_engines(hrnet_weights, INT8_SCORING=True, INT8_SCORING_HRNET=True)
    assert port.use_int8 and jax_engine.use_int8
    images, proj, valid, gt = _inputs()
    jax_scales = jax_engine.int8_calibrate(params, stats, jnp.asarray(images))
    scales = port.int8_calibrate(images)
    assert set(scales) == set(jax_scales) and "stem1" in scales
    ref = np.asarray(jax_engine.forward(params, stats, jnp.asarray(images), jax_scales))
    ref = ref.transpose(0, 1, 4, 2, 3)
    got = port.forward(images, scales).numpy()
    cos = float(np.dot(got.ravel(), ref.ravel()) / (np.linalg.norm(got) * np.linalg.norm(ref)))
    same = got.reshape(B, V, K, -1).argmax(-1) == ref.reshape(B, V, K, -1).argmax(-1)
    assert cos > 0.999 and same.mean() >= 0.95, (cos, same.mean())
    flt = port.forward(images, use_int8=False).numpy()
    assert float(np.dot(got.ravel(), flt.ravel()) / (np.linalg.norm(got) * np.linalg.norm(flt))) > 0.99
    out = port.score_step(images, proj, valid, port.pairs(V), gt, int8_scales=scales)
    assert out["keypoints_3d"].shape == (B, K, 3) and all(torch.isfinite(v).all() for v in out.values())
