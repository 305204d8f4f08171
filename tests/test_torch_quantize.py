"""The port's int8 PoseResNet forward (models/quantize.py) against the JAX
package's, on the same weights (the ResNet-18 forward goldens' weights,
carried by from_flax) and inputs.

Tolerances:
  * s8 weights, per-channel weight scales, s8 activations and s32
    accumulators: equal.
  * One int8 conv + folded BN: the bf16 outputs within one bf16 step
    (2^-7 relative); the BN fold is within one float32 rounding of the JAX
    one (XLA computes gamma / sqrt(v) as gamma * rsqrt(v)).
  * The whole forward (dynamic scales, a JAX-calibrated static table, a
    float tail, the K4 head): cosine > 0.999 and per-map argmax agreement
    >= 0.95 against the JAX forward.  Measured: cosine 1.0000 and agreement
    1.0, max error about 2e-4 of a 0.58 scale; the bf16 steps of single
    elements propagate, so the forward is not bitwise.
  * Calibrated scale tables: the same keys, values within rtol 1e-5.
"""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import golden_fill_values
from multi_view_active_learning_tpu.models import convert as jax_convert
from multi_view_active_learning_tpu.models import quantize as jq
from multi_view_active_learning_tpu.ops.pallas import deconv as jax_deconv
from multi_view_active_learning_tpu_torch.models import quantize as tq
from multi_view_active_learning_tpu_torch.models.convert import from_flax, scales_from_jax
from multi_view_active_learning_tpu_torch.ops.int8 import int8_matmul

GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures", "model_forward_goldens.npz")
DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(scope="module")
def weights():
    """(flax params, flax batch_stats, port state dict) of PoseResNet-18."""
    g = np.load(GOLDENS)
    names = json.loads(bytes(g["pose_resnet18_names"]).decode())
    shapes = json.loads(bytes(g["pose_resnet18_shapes"]).decode())
    values = golden_fill_values(names, shapes, int(g["weight_seed"]))
    params, stats = jax_convert.torch_state_dict_to_flax(values, "POSE_RESNET")
    return params, stats, from_flax(params, stats)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)


def _bf16(rng, shape, scale=1.0):
    """Seeded values that are exact in bf16, as float32 numpy."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("path", [("conv1",), ("layer1_0", "conv2"), ("layer2_0", "downsample_conv")],
                         ids=lambda p: "/".join(p))
def test_quant_weight_bit_equal_to_jax(weights, path):
    params, _, sd = weights
    node = params
    for p in path:
        node = node[p]
    ref_q, ref_s = jq._quant_weight(jnp.asarray(node["kernel"]))
    torch_name = {"conv1": "conv1", "layer1_0/conv2": "layer1.0.conv2",
                  "layer2_0/downsample_conv": "layer2.0.downsample.0"}["/".join(path)]
    wq, ws = tq._quant_weight(sd[torch_name + ".weight"])
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(ref_s))


def test_quant_act_equal_to_jax():
    x = _bf16(np.random.default_rng(2), (2, 9, 9, 16), 3.0)
    sx = np.float32(np.abs(x).max() / 127.0)
    ref = jq._quant_act(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(sx))
    got = tq._quant_act(torch.from_numpy(x).to(torch.bfloat16), torch.tensor(sx))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


CONVS = {  # name: (input NHWC, kernel HWIO, stride)
    "stem7x7s2": ((2, 20, 20, 3), (7, 7, 3, 16), 2),
    "3x3s1": ((2, 9, 9, 16), (3, 3, 16, 24), 1),
    "3x3s2": ((2, 9, 9, 16), (3, 3, 16, 8), 2),
    "1x1s2": ((2, 9, 9, 16), (1, 1, 16, 32), 2),
    "tiny_m": ((1, 2, 2, 8), (3, 3, 8, 8), 1),  # 4 rows: padded to _int_mm's 17
}


@pytest.mark.parametrize("name", list(CONVS))
def test_int8_conv_s32_equal_to_xla(name):
    xshape, kshape, stride = CONVS[name]
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, size=xshape).astype(np.int8)
    wq = rng.integers(-127, 128, size=kshape).astype(np.int8)
    pad = kshape[0] // 2
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=DN, preferred_element_type=jnp.int32)
    got = tq._int8_conv(torch.from_numpy(xq), torch.from_numpy(wq).permute(3, 0, 1, 2).contiguous(),
                        stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("conv,stride,relu", [("conv1", 1, True), ("conv2", 1, False)])
def test_qconv_bn_within_one_bf16_step(weights, conv, stride, relu):
    params, stats, sd = weights
    x = np.abs(_bf16(np.random.default_rng(4), (2, 16, 16, 64)))
    p, s = params["layer1_0"], stats["layer1_0"]
    bn = "bn" + conv[-1]
    ref = jq._qconv_bn(jnp.asarray(x).astype(jnp.bfloat16), p[conv], p[bn], s[bn], jq._ActScales(),
                       "layer1_0/" + conv, (stride, stride), relu=relu)
    qp = tq.quantize_state_dict(sd, 18)
    got = tq._qconv_bn(torch.from_numpy(x).to(torch.bfloat16), qp, "layer1.0." + conv,
                       "layer1.0." + bn, tq._ActScales(), "layer1_0/" + conv, stride, relu)
    assert got.dtype == torch.bfloat16
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert (np.abs(got - ref) <= 2.0**-7 * np.abs(ref)).all(), np.abs(got - ref).max()
    assert (got != ref).mean() < 0.01  # single elements, not a drift


def test_fconv_bn_close_to_jax(weights):
    """The float tail's bf16 conv: sums in another order, rounded to bf16 in
    both, then the float32 BN: within two bf16 steps plus 1e-3 of scale."""
    params, stats, sd = weights
    x = np.abs(_bf16(np.random.default_rng(5), (2, 8, 8, 256)))
    p, s = params["layer4_0"], stats["layer4_0"]
    ref = jq._fconv_bn(jnp.asarray(x).astype(jnp.bfloat16), p["conv1"], p["bn1"], s["bn1"], (2, 2))
    got = tq._fconv_bn(torch.from_numpy(x).to(torch.bfloat16), tq.quantize_state_dict(sd, 18),
                       "layer4.0.conv1", "layer4.0.bn1", None, None, 2)
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= 2.0**-6 * np.abs(ref) + 1e-3 * np.abs(ref).max()).all()


def _agreement(got, ref):
    a, b = got.ravel(), ref.ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    n, h, w, k = ref.shape
    agree = float((got.reshape(n, h * w, k).argmax(1) == ref.reshape(n, h * w, k).argmax(1)).mean())
    return cos, agree


@pytest.fixture(scope="module")
def jax_calibration(weights, images):
    """The JAX forward with dynamic scales, and the table it recorded."""
    params, stats, _ = weights
    out, table = jq.quantized_pose_resnet_forward(
        params, stats, jnp.asarray(images), 18, collect_scales=True)
    return np.asarray(out), {k: np.asarray(v) for k, v in table.items()}


def _port(weights, images, int8_head=False, **kw):
    qp = tq.quantize_state_dict(weights[2], 18, int8_head=int8_head)
    out = tq.quantized_pose_resnet_forward(qp, torch.from_numpy(images), 18,
                                           int8_head=int8_head, **kw)
    if kw.get("collect_scales"):
        out, table = out
        return out.permute(0, 2, 3, 1).numpy(), table
    return out.permute(0, 2, 3, 1).numpy()


def test_forward_dynamic_scales_matches_jax(weights, images, jax_calibration):
    ref, _ = jax_calibration
    got = _port(weights, images)
    assert got.shape == ref.shape == (2, 16, 16, int(np.load(GOLDENS)["num_joints"]))
    cos, agree = _agreement(got, ref)
    assert cos > 0.999 and agree >= 0.95, (cos, agree)


def test_calibrated_tables_match_jax(weights, images, jax_calibration):
    _, ref_table = jax_calibration
    _, table = _port(weights, images, collect_scales=True)
    assert set(table) == set(ref_table)
    assert "stem" in table and "layer4_1/conv2" in table and "layer2_0/down" in table
    for name, value in table.items():
        np.testing.assert_allclose(value.numpy(), ref_table[name], rtol=1e-5)


def test_forward_static_jax_table_matches_jax(weights, images, jax_calibration):
    params, stats, _ = weights
    _, table = jax_calibration
    ref = np.asarray(jq.quantized_pose_resnet_forward(
        params, stats, jnp.asarray(images), 18, act_scales={k: jnp.asarray(v) for k, v in table.items()}))
    got = _port(weights, images, act_scales=scales_from_jax(table))
    cos, agree = _agreement(got, ref)
    assert cos > 0.999 and agree >= 0.95, (cos, agree)


def test_forward_float_tail_matches_jax(weights, images):
    params, stats, _ = weights
    ref = np.asarray(jq.quantized_pose_resnet_forward(
        params, stats, jnp.asarray(images), 18, float_tail_stages=1))
    got = _port(weights, images, float_tail_stages=1)
    cos, agree = _agreement(got, ref)
    assert cos > 0.999 and agree >= 0.95, (cos, agree)


def test_forward_int8_head_matches_jax(weights, images):
    """int8_head=True: the JAX forward with its Pallas kernel in interpret
    mode (as tests/test_pallas_kernels.py:193-205), the port through K4's
    wrapper (its plain version on the CPU)."""
    params, stats, _ = weights
    real = jax_deconv.fused_deconv_bn_relu_int8

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    with mock.patch.object(jax_deconv, "fused_deconv_bn_relu_int8", interp):
        ref, ref_table = jq.quantized_pose_resnet_forward(
            params, stats, jnp.asarray(images), 18, int8_head=True, collect_scales=True)
    got, table = _port(weights, images, int8_head=True, collect_scales=True)
    assert {"deconv0", "deconv1", "deconv2"} <= set(table) and set(table) == set(ref_table)
    cos, agree = _agreement(got, np.asarray(ref))
    assert cos > 0.999 and agree >= 0.95, (cos, agree)


def test_quantize_state_dict_contents(weights):
    params, stats, sd = weights
    qp = tq.quantize_state_dict(sd, 18)
    assert qp["conv1.wq"].shape == (64, 7, 7, 3) and qp["conv1.wq"].dtype == torch.int8
    assert qp["layer2.0.downsample.0.wq"].shape == (128, 1, 1, 64)
    assert "layer1.0.downsample.0.wq" not in qp  # ResNet-18's first stage has none
    assert "deconv_layers.0.wq" not in qp and qp["deconv_layers.0.weight"].dtype == torch.bfloat16
    assert qp["final_layer.weight"].dtype == torch.float32
    head = tq.quantize_state_dict(sd, 18, int8_head=True)
    assert head["deconv_layers.3.wq"].shape == sd["deconv_layers.3.weight"].shape
    ref_scale, ref_bias = jq._bn_fold(params["layer3_1"]["bn2"], stats["layer3_1"]["bn2"])
    np.testing.assert_allclose(qp["layer3.1.bn2.scale"].numpy(), np.asarray(ref_scale), rtol=2.0**-22)
    np.testing.assert_allclose(qp["layer3.1.bn2.bias"].numpy(), np.asarray(ref_bias),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("m,k,n", [(3, 147, 64), (17, 8, 12), (40, 576, 64), (16, 20, 8)])
def test_int8_matmul_is_exact_at_any_shape(m, k, n):
    rng = np.random.default_rng(m * k * n)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_scales_from_jax():
    table = {"stem": jnp.float32(0.03), "deconv0": np.float32(0.5)}
    got = scales_from_jax(table)
    assert set(got) == set(table)
    assert all(v.dtype == torch.float32 and v.shape == () for v in got.values())
    assert float(got["stem"]) == float(np.float32(0.03))


# -- HRNet: the int8 forward of a narrow HRNet against the JAX package's ----

HRNET_NARROW = dict(stage2=(1, 2, "BASIC", (1, 1), (8, 16)),
                    stage3=(2, 3, "BASIC", (1, 1, 1), (8, 16, 32)),
                    stage4=(1, 4, "BASIC", (1, 1, 1, 1), (8, 16, 32, 64)))


@pytest.fixture(scope="module")
def hrnet():
    """(flax params, stats, port state dict, images, the JAX int8 forward
    with dynamic scales and its recorded table) of a narrow HRNet."""
    from multi_view_active_learning_tpu.models.hrnet import PoseHighResolutionNet as FlaxHRNet

    model = FlaxHRNet(num_joints=4, **HRNET_NARROW)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                               train=False))
    zeros = jax_convert.flax_to_torch_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"]),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"]),
        "HRNET")
    values = golden_fill_values(list(zeros), [a.shape for a in zeros.values()], 13)
    params, stats = jax_convert.torch_state_dict_to_flax(values, "HRNET")
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    out, table = jq.quantized_hrnet_forward(params, stats, jnp.asarray(x), collect_scales=True,
                                            **HRNET_NARROW)
    return dict(params=params, stats=stats, sd=from_flax(params, stats, "HRNET"), x=x,
                ref=np.asarray(out), table={k: np.asarray(v) for k, v in table.items()})


def _port_hrnet(h, **kw):
    qp = tq.quantize_state_dict(h["sd"], 0, model_type="HRNET")
    out = tq.quantized_hrnet_forward(qp, torch.from_numpy(h["x"]), final_conv_kernel=1,
                                     **HRNET_NARROW, **kw)
    if kw.get("collect_scales"):
        out, table = out
        return out.permute(0, 2, 3, 1).numpy(), table
    return out.permute(0, 2, 3, 1).numpy()


def test_hrnet_int8_dynamic_scales_matches_jax(hrnet):
    got = _port_hrnet(hrnet)
    assert got.shape == hrnet["ref"].shape == (2, 16, 16, 4)
    cos, agree = _agreement(got, hrnet["ref"])
    assert cos > 0.999 and agree >= 0.95, (cos, agree)


def test_hrnet_scale_table_keys_and_values_match_jax(hrnet):
    _, table = _port_hrnet(hrnet, collect_scales=True)
    ref = hrnet["table"]
    assert set(table) == set(ref)
    for key in ("stem1", "stem2", "layer1_0/down", "transition1_0", "transition1_1_0",
                "transition3_3_0", "stage2_module0/branch1_block0/conv2", "stage3_module1/fuse0_2",
                "stage3_module1/fuse2_0_1", "stage4_module0/fuse0_3"):
        assert key in table, key
    for name, value in table.items():
        np.testing.assert_allclose(value.numpy(), ref[name], rtol=1e-5)


def test_hrnet_int8_static_jax_table_matches_jax(hrnet):
    table = hrnet["table"]
    ref = np.asarray(jq.quantized_hrnet_forward(
        hrnet["params"], hrnet["stats"], jnp.asarray(hrnet["x"]),
        act_scales={k: jnp.asarray(v) for k, v in table.items()}, **HRNET_NARROW))
    got = _port_hrnet(hrnet, act_scales=scales_from_jax(table))
    cos, agree = _agreement(got, ref)
    assert cos > 0.999 and agree >= 0.95, (cos, agree)


def test_hrnet_int8_meets_the_jax_bar_against_float(hrnet):
    """tests/test_quantize.py:153: cosine > 0.99 against the float forward."""
    from multi_view_active_learning_tpu_torch.models import PoseHighResolutionNet

    model = PoseHighResolutionNet(4, **HRNET_NARROW).eval()
    model.load_state_dict(hrnet["sd"], strict=True)
    with torch.no_grad():
        flt = model(torch.from_numpy(np.ascontiguousarray(hrnet["x"].transpose(0, 3, 1, 2))))
    cos, _ = _agreement(_port_hrnet(hrnet), flt.permute(0, 2, 3, 1).numpy())
    assert cos > 0.99, cos


def test_hrnet_quantize_state_dict_contents(hrnet):
    qp = tq.quantize_state_dict(hrnet["sd"], 0, model_type="HRNET")
    assert qp["conv1.wq"].shape == (64, 3, 3, 3) and qp["conv1.wq"].dtype == torch.int8
    assert qp["stage3.1.fuse_layers.2.0.1.0.wq"].shape == (32, 3, 3, 8)  # [Cout, k, k, Cin]
    assert qp["stage2.0.fuse_layers.0.1.1.scale"].shape == (8,)
    assert qp["transition3.3.0.0.ws"].shape == (64,)
    assert qp["final_layer.weight"].dtype == torch.float32
    assert not any(k.startswith("final_layer") and k.endswith(".wq") for k in qp)
