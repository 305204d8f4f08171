"""The port's HRNet (models/hrnet.py) and its flax -> torch converter.

  * HRNet-W32 against the reference forward goldens
    (tests/fixtures/model_forward_goldens.npz, weights from
    helpers.golden_fill_values): max error <= 1e-4 * max|output| and cosine
    > 0.999999, the bounds of tests/test_model_forward_parity.py.
  * ``from_flax(..., "HRNET")`` equals the JAX package's
    ``flax_to_torch_state_dict(..., "HRNET")`` key for key and array for
    array, and strict-loads into HRNet-W32.
  * A narrow HRNet (widths 8/16/32/64, one block a branch, two modules in
    stage 3) against the flax forward on the same weights, 64x64 crops:
    float32 max error <= 1e-4 * max|output|, heatmaps and return_features;
    bfloat16 (both frameworks round every layer to 8 mantissa bits, in other
    places) max error <= 0.05 * max|output| and cosine > 0.999.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import golden_fill_values
from multi_view_active_learning_tpu.config import get_default_configs as jax_default_configs
from multi_view_active_learning_tpu.models import build_model as jax_build_model
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.models.hrnet import PoseHighResolutionNet as FlaxHRNet
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.models import PoseHighResolutionNet, build_model
from multi_view_active_learning_tpu_torch.models.convert import from_flax

GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures", "model_forward_goldens.npz")
NARROW = dict(stage2=(1, 2, "BASIC", (1, 1), (8, 16)),
              stage3=(2, 3, "BASIC", (1, 1, 1), (8, 16, 32)),
              stage4=(1, 4, "BASIC", (1, 1, 1, 1), (8, 16, 32, 64)))


@pytest.fixture(scope="module")
def goldens():
    g = np.load(GOLDENS)
    names = json.loads(bytes(g["hrnet_w32_names"]).decode())
    shapes = json.loads(bytes(g["hrnet_w32_shapes"]).decode())
    return g, golden_fill_values(names, shapes, int(g["weight_seed"]))


def _close(y, ref, rtol=1e-4):
    scale = np.abs(ref).max()
    max_err = np.abs(y - ref).max()
    cos = float(np.dot(y.ravel(), ref.ravel()) / (np.linalg.norm(y) * np.linalg.norm(ref)))
    assert max_err <= rtol * scale, (max_err, scale, cos)
    return cos


def test_w32_forward_matches_reference_goldens(goldens):
    g, values = goldens
    model = PoseHighResolutionNet(int(g["num_joints"])).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in values.items()}, strict=True)
    hw, batch = int(g["input_hw"]), int(g["batch"])
    x = np.random.default_rng(int(g["input_seed"])).normal(size=(batch, 3, hw, hw))
    with torch.no_grad():
        y = model(torch.from_numpy(x.astype(np.float32))).numpy()
    ref = g["hrnet_w32_output"]
    assert y.shape == ref.shape == (batch, int(g["num_joints"]), hw // 4, hw // 4)
    assert _close(y, ref) > 0.999999


def test_from_flax_equals_jax_converter(goldens):
    g, values = goldens
    params, stats = jax_convert.torch_state_dict_to_flax(values, "HRNET")
    got = from_flax(params, stats, "HRNET")
    ref = jax_convert.flax_to_torch_state_dict(params, stats, "HRNET")
    assert set(got) == set(ref) == set(values)
    for name, arr in got.items():
        assert arr.dtype == torch.float32
        np.testing.assert_array_equal(arr.numpy(), ref[name])
        np.testing.assert_array_equal(arr.numpy(), values[name])  # round trip
    PoseHighResolutionNet(int(g["num_joints"])).load_state_dict(got, strict=True)


def test_build_model_gives_w32_from_the_config():
    cfg = get_default_configs()
    cfg.POSE_ESTIMATOR.TYPE = "HRNET"
    cfg.DATA.NUM_JOINTS = 19
    model = build_model(cfg)
    assert isinstance(model, PoseHighResolutionNet)
    assert model.stage4[0].branches[3][0].conv1.weight.shape == (256, 256, 3, 3)
    assert len(model.stage3) == 4 and len(model.stage4) == 3
    assert model.final_layer.weight.shape == (19, 32, 1, 1)
    assert model.conv1.weight.dtype == torch.bfloat16  # the default compute dtype
    assert model.final_layer.weight.dtype == model.bn1.weight.dtype == torch.float32
    jcfg = jax_default_configs()
    jcfg.POSE_ESTIMATOR.TYPE = "HRNET"
    assert jax_build_model(jcfg).stage4 == (3, 4, "BASIC", (4, 4, 4, 4), (32, 64, 128, 256))


def _narrow_weights(num_joints=4, seed=3):
    """Flax params / stats of the narrow HRNet, filled with O(1)-activation
    values through the torch names."""
    model = FlaxHRNet(num_joints=num_joints, **NARROW)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                               train=False))
    zeros = jax_convert.flax_to_torch_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"]),
        "HRNET")
    values = golden_fill_values(list(zeros), [a.shape for a in zeros.values()], seed)
    return jax_convert.torch_state_dict_to_flax(values, "HRNET")


@pytest.fixture(scope="module")
def narrow():
    params, stats = _narrow_weights()
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    outs = {}
    for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        model = FlaxHRNet(num_joints=4, dtype=dtype, **NARROW)
        heat, pooled = jax.jit(lambda p, s, xi: model.apply(
            {"params": p, "batch_stats": s}, xi, train=False, return_features=True))(
                params, stats, jnp.asarray(x))
        outs[name] = (np.asarray(heat).transpose(0, 3, 1, 2), np.asarray(pooled))
    return params, stats, x, outs


def _port_narrow(params, stats, dtype):
    model = PoseHighResolutionNet(4, dtype=dtype, **NARROW).eval()
    model.load_state_dict(from_flax(params, stats, "HRNET"), strict=True)
    return model


def test_narrow_forward_matches_flax_float32(narrow):
    params, stats, x, outs = narrow
    model = _port_narrow(params, stats, torch.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        y = model(xt).numpy()
        heat, pooled = model(xt, return_features=True)
    ref_heat, ref_pooled = outs["float32"]
    assert y.shape == (2, 4, 16, 16) and y.dtype == np.float32
    _close(y, ref_heat)
    np.testing.assert_array_equal(heat.numpy(), y)
    assert pooled.shape == (2, 8) and pooled.dtype == torch.float32
    _close(pooled.numpy(), ref_pooled)


def test_narrow_forward_matches_flax_bfloat16(narrow):
    params, stats, x, outs = narrow
    model = _port_narrow(params, stats, torch.bfloat16)
    assert model.conv1.weight.dtype == torch.bfloat16
    assert model.stage2[0].fuse_layers[0][1][0].weight.dtype == torch.bfloat16
    with torch.no_grad():
        heat, pooled = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                             return_features=True)
    assert heat.dtype == pooled.dtype == torch.float32
    for got, ref in ((heat.numpy(), outs["bfloat16"][0]), (pooled.numpy(), outs["bfloat16"][1])):
        cos = _close(got, ref, rtol=0.05)
        assert cos > 0.999, cos
