"""The exact reformulation options of the port (ROADMAP A12) against the
standard layers and against the JAX package's modules on the same
parameters (carried by ``from_flax``), after JAX's own tests
(tests/test_models.py:114-180, tests/test_quantize.py:341,
tests/test_packed_conv.py):

  * ``ops/packed_conv.py``: ``pack_kernel_2x2`` equals JAX's (transposed to
    torch's layout) bit for bit; ``packed_conv3x3`` equals ``F.conv2d`` and
    JAX's packed conv within float32 rounding (rtol 1e-4 of the scale);
  * ``TPU.HRNET_PACKED_MAX_CH``: a narrow HRNet with packed branches equals
    the standard one; odd branch resolutions fall
    back to the standard conv (JAX's
    tests/test_packed_conv.py::test_hrnet_packed_odd_spatial_falls_back);
  * ``TPU.SPACE_TO_DEPTH_STEM``: PoseResNet-18 on space-to-depth'd input
    equals the plain input and JAX's model on the same input; the engine's
    uint8 path equals the plain engine; the int8 stem on the remapped s8
    weights is bit-equal to the plain int8 forward and within JAX's int8
    bar of JAX's int8 s2d forward;
  * ``TPU.FAST_DECONV``: PhaseDeconv equals ConvTranspose2d, PoseResNet-18
    with it equals the standard model and JAX's fast-deconv model, and its
    training gradients equal the standard model's.

Float32 throughout (TF32 is a card matter): rtol 1e-4 and atol 1e-4 of the
output's scale, JAX's bar for these options.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_view_active_learning_tpu.config import get_default_configs as jax_configs
from multi_view_active_learning_tpu.engine import Engine as JaxEngine
from multi_view_active_learning_tpu.models import PoseResNet as JaxPoseResNet
from multi_view_active_learning_tpu.models import quantize as jax_quantize
from multi_view_active_learning_tpu.models.pose_resnet import space_to_depth as jax_s2d
from multi_view_active_learning_tpu.ops import packed_conv as jax_packed
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.engine import Engine
from multi_view_active_learning_tpu_torch.models import quantize
from multi_view_active_learning_tpu_torch.models.convert import from_flax
from multi_view_active_learning_tpu_torch.models.hrnet import PoseHighResolutionNet
from multi_view_active_learning_tpu_torch.models.layers import Conv2d, ConvTranspose2d
from multi_view_active_learning_tpu_torch.models.pose_resnet import (PackedConv2d, PhaseDeconv,
                                                                     PoseResNet, space_to_depth)
from multi_view_active_learning_tpu_torch.ops.packed_conv import pack_kernel_2x2, packed_conv3x3

RTOL = ATOL_OF_SCALE = 1e-4
K, IMG = 5, 64


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL_OF_SCALE * np.abs(ref).max(),
                               err_msg=what)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


# -- the packed 3x3 conv -------------------------------------------------------------


def test_pack_kernel_matches_jax():
    k = np.random.default_rng(0).normal(size=(3, 3, 6, 4)).astype(np.float32)  # HWIO
    ref = np.asarray(jax_packed.pack_kernel_2x2(jnp.asarray(k)))  # [4, 4, Ci, 4 Co]
    got = pack_kernel_2x2(torch.from_numpy(k).permute(3, 2, 0, 1)).numpy()  # [4 Co, Ci, 4, 4]
    np.testing.assert_array_equal(got, ref.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError):
        pack_kernel_2x2(torch.zeros(4, 6, 1, 1))


@pytest.mark.parametrize("c_in,c_out", [(8, 32), (16, 8)])
def test_packed_conv_matches_conv_and_jax(c_in, c_out):
    rng = np.random.default_rng(c_in)
    x = rng.normal(size=(2, 12, 10, c_in)).astype(np.float32)  # NHWC
    k = rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32)  # HWIO
    w = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
    got = packed_conv3x3(_nchw(x), w).numpy()
    _close(got, F.conv2d(_nchw(x), w, padding=1).numpy(), "conv2d")
    ref = np.asarray(jax_packed.packed_conv3x3(jnp.asarray(x), jnp.asarray(k)))
    _close(got, np.moveaxis(ref, -1, 1), "jax")
    with pytest.raises(ValueError):
        packed_conv3x3(_nchw(x[:, :11]), w)


HRNET_KW = dict(num_joints=3, stage2=(1, 2, "BASIC", (1, 1), (8, 16)),
                stage3=(1, 3, "BASIC", (1, 1, 1), (8, 16, 32)),
                stage4=(1, 4, "BASIC", (1, 1, 1, 1), (8, 16, 32, 64)))


def test_hrnet_packed_matches_standard():
    """A narrow HRNet with its 8- and 16-channel branches packed computes the
    standard HRNet's heatmaps on the same weights (each packed conv is held
    to JAX's packed conv above)."""
    plain, packed = PoseHighResolutionNet(**HRNET_KW), PoseHighResolutionNet(
        packed_max_channels=16, **HRNET_KW)
    packed.load_state_dict(plain.state_dict(), strict=True)
    kinds = [type(m).__name__ for m in packed.modules()]
    # Branches 0 and 1 (8 and 16 channels) of each of the three stage
    # modules, a BasicBlock of 2 convs each.
    assert kinds.count("PackedConv2d") == 3 * 2 * 2
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, ref = packed.eval()(x), plain.eval()(x)
    _close(got.numpy(), ref.numpy())


def test_hrnet_packed_odd_spatial_falls_back():
    """A 32x32 input reaches a 1x1 branch; packing everything falls back to
    the standard conv there."""
    kw = dict(num_joints=2, stage2=(1, 2, "BASIC", (1, 1), (4, 8)),
              stage3=(1, 3, "BASIC", (1, 1, 1), (4, 8, 16)),
              stage4=(1, 4, "BASIC", (1, 1, 1, 1), (4, 8, 16, 32)))
    packed, plain = PoseHighResolutionNet(packed_max_channels=999, **kw), PoseHighResolutionNet(**kw)
    plain.load_state_dict(packed.state_dict(), strict=True)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, ref = packed.eval()(x), plain.eval()(x)
    assert got.shape == (1, 2, 8, 8)
    _close(got.numpy(), ref.numpy())


# -- PoseResNet: the space-to-depth stem and PhaseDeconv --------------------------------


@pytest.fixture(scope="module")
def resnet():
    """JAX PoseResNet-18 variables and the port's models loaded with them."""
    x = np.random.default_rng(0).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    jmodel = JaxPoseResNet(num_joints=K, num_layers=18)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    state = from_flax(variables["params"], variables["batch_stats"])
    models = {}
    for fast in (False, True):
        model = PoseResNet(K, 18, fast_deconv=fast)
        model.load_state_dict(state, strict=True)
        models[fast] = model.eval()
    return dict(x=x, variables=variables, state=state, models=models)


def test_space_to_depth_input_matches_plain_and_jax(resnet):
    x, variables = resnet["x"], resnet["variables"]
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(x))))
    model = resnet["models"][False]
    with torch.no_grad():
        plain = model(_nchw(x)).numpy()
        got = model(space_to_depth(torch.from_numpy(x)).permute(0, 3, 1, 2)).numpy()
    _close(got, plain, "plain")
    ref = JaxPoseResNet(num_joints=K, num_layers=18).apply(variables, jax_s2d(jnp.asarray(x)),
                                                           train=False)
    _close(got, np.moveaxis(np.asarray(ref), -1, 1), "jax")
    with pytest.raises(ValueError, match="stem expects 3 or 12 channels"):
        model(torch.zeros(1, 6, 32, 32))


def test_phase_deconv_matches_conv_transpose():
    g = torch.Generator().manual_seed(0)
    std = ConvTranspose2d(16, 8, 4, 2, 1, bias=False)
    fast = PhaseDeconv(16, 8, 4, 2, 1, bias=False)
    fast.weight.data.copy_(std.weight.data)
    x = torch.randn(2, 16, 5, 7, generator=g)
    with torch.no_grad():
        _close(fast(x).numpy(), std(x).numpy())


def test_fast_deconv_matches_standard_and_jax(resnet):
    x, variables = resnet["x"], resnet["variables"]
    assert sum(isinstance(m, PhaseDeconv) for m in resnet["models"][True].modules()) == 3
    with torch.no_grad():
        got = resnet["models"][True](_nchw(x)).numpy()
        base = resnet["models"][False](_nchw(x)).numpy()
    _close(got, base, "standard")
    jfast = JaxPoseResNet(num_joints=K, num_layers=18, fast_deconv=True)
    ref = jfast.apply(variables, jnp.asarray(x), train=False)
    _close(got, np.moveaxis(np.asarray(ref), -1, 1), "jax")


def _engine(**tpu):
    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = K
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = IMG
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    for key, value in tpu.items():
        setattr(cfg.TPU, key, value)
    return Engine(cfg, device="cpu")


def test_fast_deconv_trains_as_the_standard_head(resnet):
    """The train-mode loss and every gradient of one batch equal the
    standard head's (the engine's training takes the model it builds)."""
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.normal(size=(1, 2, IMG, IMG, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(size=(1, 2, K, IMG // 4, IMG // 4)).astype(np.float32))
    pvjv, fv = torch.ones(1, 2, K, dtype=torch.bool), torch.ones(1, dtype=torch.bool)
    out = []
    for fast in (False, True):
        engine = _engine(FAST_DECONV=fast)
        state = engine.state_from_state_dict(resnet["state"])
        out.append(engine.loss_and_grads(state, images, gt, pvjv, fv))
    (loss0, grads0), (loss1, grads1) = out
    _close(loss1.numpy(), loss0.numpy(), "loss")
    assert set(grads0) == set(grads1)
    for name in grads0:
        _close(grads1[name].numpy(), grads0[name].numpy(), name)


def test_engine_space_to_depth_path_matches_plain_and_jax(resnet):
    """The engine's uint8 space-to-depth path (the frames rearranged before
    normalization, mean and std tiled by 4) against the plain engine and
    the JAX engine's s2d path, on the same weights."""
    images = np.random.default_rng(4).integers(0, 256, size=(1, 2, IMG, IMG, 3)).astype(np.uint8)
    heat = []
    for s2d in (False, True):
        engine = _engine(SPACE_TO_DEPTH_STEM=s2d)
        engine.load_state_dict(resnet["state"])
        heat.append(engine.forward(images).numpy())
    _close(heat[1], heat[0], "plain")
    cfg = jax_configs()
    cfg.DATA.NUM_JOINTS, cfg.POSE_ESTIMATOR.NUM_LAYERS = K, 18
    cfg.TPU.COMPUTE_DTYPE, cfg.TPU.INT8_SCORING, cfg.TPU.SPACE_TO_DEPTH_STEM = "float32", False, True
    v = resnet["variables"]
    ref = np.asarray(JaxEngine(cfg).forward(v["params"], v["batch_stats"], jnp.asarray(images)))
    _close(heat[1], ref.transpose(0, 1, 4, 2, 3), "jax")


def test_serve_fn_space_to_depth_matches_plain(resnet):
    """The serve function takes the engine's space-to-depth path (JAX
    serving calls the engine's forward): the same heatmaps, keypoints and
    confidences as the plain serve function."""
    from multi_view_active_learning_tpu_torch.serving import build_serve_fn

    images = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, size=(1, 2, IMG, IMG, 3)).astype(np.uint8))
    boxes = torch.tensor([[[0.0, 0.0, 200.0, 200.0]] * 2])
    outs = []
    for s2d in (False, True):
        serve = build_serve_fn(_engine(SPACE_TO_DEPTH_STEM=s2d), resnet["state"])
        assert serve.s2d_stem is s2d
        with torch.no_grad():
            outs.append(serve(images, boxes))
    for name in outs[0]:
        _close(outs[1][name].numpy(), outs[0][name].numpy(), name)


def test_int8_space_to_depth_stem_is_exact(resnet):
    """The s8 stem on the remapped weights sums the same integer products:
    bit-equal to the plain int8 forward at the same scales; against JAX's
    int8 s2d forward within the int8 bar of tests/test_torch_quantize.py
    (cosine > 0.999, argmax agreement >= 0.95)."""
    x, v = resnet["x"][:1, :32, :32], resnet["variables"]
    qp = quantize.quantize_state_dict(resnet["state"], 18)
    _, scales = quantize.quantized_pose_resnet_forward(qp, torch.from_numpy(x), 18,
                                                       collect_scales=True)
    plain = quantize.quantized_pose_resnet_forward(qp, torch.from_numpy(x), 18, act_scales=scales)
    got = quantize.quantized_pose_resnet_forward(qp, space_to_depth(torch.from_numpy(x)), 18,
                                                 act_scales=scales)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    forward = jax.jit(lambda p, s, x: jax_quantize.quantized_pose_resnet_forward(p, s, x, 18))
    ref = np.moveaxis(np.asarray(forward(v["params"], v["batch_stats"], jax_s2d(jnp.asarray(x)))),
                      -1, 1)
    got = got.numpy()
    cos = float(np.dot(got.ravel(), ref.ravel()) / (np.linalg.norm(got) * np.linalg.norm(ref)))
    same = got.reshape(1, K, -1).argmax(-1) == ref.reshape(1, K, -1).argmax(-1)
    assert cos > 0.999 and same.mean() >= 0.95, (cos, same.mean())


def test_options_build_for_every_model():
    """The three options are accepted together, and each applies where JAX
    applies it: FAST_DECONV and the stem to PoseResNet, packing to HRNet."""
    engine = _engine(SPACE_TO_DEPTH_STEM=True, FAST_DECONV=True, HRNET_PACKED_MAX_CH=32)
    assert sum(isinstance(m, PhaseDeconv) for m in engine.model.modules()) == 3
    assert not any(isinstance(m, PackedConv2d) for m in engine.model.modules())
    assert isinstance(PackedConv2d(4, 4, 3, 1, 1, bias=False), Conv2d)
