"""K3 and K4 (fused deconv + BN + ReLU): the port's plain versions against
the JAX package's Pallas kernels in interpret mode, against
F.conv_transpose2d + BN + ReLU, the packed weight layout of the CUDA
kernels against the phase formula, and the kernels' tile walk (TMA boxes
read with zeros outside, from ``tile_plan``) against conv_transpose2d.

Tolerances:
  * K3 in float32 against the interpret kernel and against
    conv_transpose2d: rtol = atol = 1e-4, the JAX test's bound
    (tests/test_pallas_kernels.py:79-115), sums in another order.
  * K3 in bfloat16 against the interpret kernel: one bf16 rounding step
    (2^-7 relative) plus 1e-4 of the output scale; both accumulate the same
    bf16 products in float32, in another order.
  * K4: the s8 weights are bit-equal; the s32 accumulator is exact, so the
    outputs agree to the float32 epilogue, rtol 1e-5 and atol 1e-4 as
    tests/test_pallas_kernels.py:163.
  * The head against the JAX head (float32): rtol = atol = 1e-4.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_view_active_learning_tpu.models.convert import deconv_weight_to_torch
from multi_view_active_learning_tpu.models.pose_resnet import PoseResNet as FlaxPoseResNet
from multi_view_active_learning_tpu.ops.pallas import deconv as jax_deconv
from multi_view_active_learning_tpu_torch import kernels
from multi_view_active_learning_tpu_torch.kernels import _build, deconv
from multi_view_active_learning_tpu_torch.models import PoseResNet
from multi_view_active_learning_tpu_torch.models.convert import from_flax

SHAPES = [(3, 4, 4, 640, 64), (2, 8, 8, 96, 64)]  # the JAX test's (N, H, W, Cin, Cout)


def _problem(seed, shape):
    """The JAX test's inputs: x NHWC, a flax kernel [4, 4, Cin, Cout], BN."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    k = rng.normal(scale=0.05, size=(4, 4, cin, cout)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    beta = rng.normal(size=cout).astype(np.float32)
    mean = rng.normal(size=cout).astype(np.float32)
    var = rng.uniform(0.1, 2.0, cout).astype(np.float32)
    return x, k, (gamma, beta, mean, var)


def _torch_weight(k):
    return torch.from_numpy(np.ascontiguousarray(deconv_weight_to_torch(k)))


def _folds(bn):
    return deconv.fold_bn(*(torch.from_numpy(a) for a in bn))


def test_fold_bn_matches_jax():
    """Within one float32 rounding: XLA computes gamma / sqrt(v) as
    gamma * rsqrt(v)."""
    _, _, bn = _problem(0, SHAPES[1])
    got = _folds(bn)
    ref = jax_deconv.fold_bn(*(jnp.asarray(a) for a in bn))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2.0**-22, atol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k3_plain_matches_pallas_interpret(shape):
    x, k, bn = _problem(3, shape)
    scale, bias = _folds(bn)
    ref = jax_deconv.fused_deconv_bn_relu(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
        interpret=True)
    got = deconv.fused_deconv_bn_relu(torch.from_numpy(x), _torch_weight(k), scale, bias)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k3_plain_matches_conv_transpose(shape):
    x, k, bn = _problem(4, shape)
    scale, bias = _folds(bn)
    w = _torch_weight(k)
    y = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=2, padding=1)
    ref = torch.relu(y * scale[:, None, None] + bias[:, None, None]).permute(0, 2, 3, 1)
    got = deconv.fused_deconv_bn_relu_plain(torch.from_numpy(x), w, scale, bias)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_k3_plain_bfloat16_matches_pallas_interpret():
    x, k, bn = _problem(5, SHAPES[1])
    scale, bias = _folds(bn)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax_deconv.fused_deconv_bn_relu(
        xb, jnp.asarray(k), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
        interpret=True).astype(jnp.float32))
    got = deconv.fused_deconv_bn_relu(
        torch.from_numpy(x).to(torch.bfloat16), _torch_weight(k), scale, bias)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    bound = 2.0**-7 * np.abs(ref) + 1e-4 * np.abs(ref).max()
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def _jax_quantized_kernel(k):
    """The JAX wrapper's weight quantization (ops/pallas/deconv.py:268-271)."""
    wf32 = jnp.asarray(k)
    ws = jnp.maximum(jnp.max(jnp.abs(wf32), axis=(0, 1, 2)), 1e-8) / 127.0
    return np.asarray(jnp.clip(jnp.round(wf32 / ws), -127, 127).astype(jnp.int8)), np.asarray(ws)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k4_weights_bit_equal_to_jax(shape):
    _, k, _ = _problem(9, shape)
    wq, ws = deconv.quantize_deconv_weight(_torch_weight(k))
    ref_q, ref_s = _jax_quantized_kernel(k)
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(wq.numpy(), deconv_weight_to_torch(ref_q))
    np.testing.assert_array_equal(ws.numpy(), ref_s)
    # The output channel of a ConvTranspose2d weight is dim 1.
    w = _torch_weight(k)
    np.testing.assert_array_equal(ws.numpy(), (torch.amax(w.abs(), dim=(0, 2, 3)) / 127).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k4_plain_matches_pallas_interpret(shape):
    x, k, bn = _problem(9, shape)
    scale, bias = _folds(bn)
    sx = np.float32(np.abs(x).max() / 127.0)
    ref = jax_deconv.fused_deconv_bn_relu_int8(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
        jnp.asarray(sx), interpret=True)
    wq, ws = deconv.quantize_deconv_weight(_torch_weight(k))
    got = deconv.fused_deconv_bn_relu_int8(
        torch.from_numpy(x), wq, ws, scale, bias, torch.tensor(sx))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_k4_bfloat16_keeps_type_and_tracks_float():
    """bf16 activations in, bf16 out, within 2% of the output scale of the
    float32 activations' result: the bf16 rounding of x moves a few
    quantized inputs by one step, and the output rounds to bf16."""
    x, k, bn = _problem(6, SHAPES[1])
    scale, bias = _folds(bn)
    wq, ws = deconv.quantize_deconv_weight(_torch_weight(k))
    sx = torch.tensor(np.abs(x).max() / 127.0, dtype=torch.float32)
    got = deconv.fused_deconv_bn_relu_int8(torch.from_numpy(x).bfloat16(), wq, ws, scale, bias, sx)
    ref = deconv.fused_deconv_bn_relu_int8(torch.from_numpy(x), wq, ws, scale, bias, sx)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).abs().max()) <= 0.02 * float(ref.abs().max())


def _emulate_kernel(x, packed, cout):
    """csrc/deconv.cu's arithmetic on its packed weights, in plain tensors:
    phase (r, s), tap t = 2a + b reads input pixel (i + r + a - 1, j + s + b
    - 1) (zero outside) against packed[2r + s, :, t, :Cin]."""
    n, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros((n, 2 * h, 2 * w, cout))
    for phase in range(4):
        r, s = phase >> 1, phase & 1
        acc = torch.zeros((n, h, w, cout))
        for tap in range(4):
            a, b = tap >> 1, tap & 1
            acc += xp[:, r + a:r + a + h, s + b:s + b + w, :] @ packed[phase, :, tap, :cin].t()
        out[:, r::2, s::2, :] = acc
    return out


@pytest.mark.parametrize("shape", SHAPES + [(2, 5, 7, 72, 64)], ids=str)
def test_packed_layout_reproduces_conv_transpose(shape):
    x, k, _ = _problem(7, shape)
    w = _torch_weight(k)
    packed = deconv.pack_weight(w)
    cin, cout = shape[3], shape[4]
    assert packed.shape == (4, cout, 4, -(-cin // deconv.CIN_ALIGN) * deconv.CIN_ALIGN)
    assert packed.is_contiguous() and bool((packed[..., cin:] == 0).all())
    ref = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=2, padding=1)
    got = _emulate_kernel(torch.from_numpy(x), packed, cout)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-4)


def _tma_box(t, start, box):
    """What a TMA load reads: the box at ``start`` (dims innermost first, so
    reversed from ``t``'s) of ``t``, zeros outside it."""
    out = t.new_zeros(tuple(reversed(box)))
    src, dst = [], []
    for d, (s, b) in enumerate(zip(start, box)):
        size = t.shape[t.dim() - 1 - d]
        lo, hi = max(s, 0), min(s + b, size)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(reversed(dst))] = t[tuple(reversed(src))]
    return out


def _emulate_tile_walk(x, packed, plan):
    """csrc/deconv.cu's tensor-core kernel in plain tensors, from the plan:
    every tile's K loop of A and B boxes, then its masked scatter."""
    n, h, w, cin = x.shape
    cout = packed.shape[1]
    xa = F.pad(x, (0, plan.cin_a - cin)).to(torch.float64)
    wb = packed.to(torch.float64)
    assert tuple(reversed(xa.shape)) == plan.a_dims and tuple(reversed(wb.shape)) == plan.b_dims
    out = torch.full((n, 2 * h, 2 * w, cout), float("nan"), dtype=torch.float64)
    box_pixels = plan.bw * plan.rows * plan.imgs
    for tile in range(plan.tiles):
        phase, n0, i0, j0, co0 = deconv.tile_coords(plan, tile)
        acc = torch.zeros((deconv.TILE_M, deconv.TILE_N), dtype=torch.float64)
        for kt in range(4 * plan.chunks):
            tap, chunk = divmod(kt, plan.chunks)
            ci, k = chunk * plan.kc, phase * 4 + tap
            a = _tma_box(xa, (ci, j0 + plan.tap_dx[k], i0 + plan.tap_dy[k], n0), plan.a_box)
            b = _tma_box(wb, (ci, tap, co0, phase), plan.b_box)
            acc[:box_pixels] += a.reshape(box_pixels, plan.kc) @ b.reshape(deconv.TILE_N, plan.kc).t()
        r, s = phase >> 1, phase & 1
        for p in range(box_pixels):
            img, rem = divmod(p, plan.bw * plan.rows)
            row, col = divmod(rem, plan.bw)
            nn, i, j = n0 + img, i0 + row, j0 + col
            if nn < n and i < h and j < w:
                cols = min(deconv.TILE_N, cout - co0)
                out[nn, 2 * i + r, 2 * j + s, co0:co0 + cols] = acc[p, :cols]
    return out


# SHAPES (Cin=640 among them), the ragged 5x7 / Cin=72 case, a row wider
# than a tile (W=130: two column tiles), Cout above one N tile (264), and
# H=20 at W=16 (8-row tiles, the last one half outside the map).
PLAN_SHAPES = SHAPES + [(2, 5, 7, 72, 64), (1, 2, 130, 8, 8), (1, 3, 3, 16, 264),
                        (2, 20, 16, 8, 8)]


@pytest.mark.parametrize("elem_bytes", [2, 1], ids=["bf16", "s8"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_tile_walk_reproduces_conv_transpose(shape, elem_bytes):
    n, h, w, cin, cout = shape
    x, k, _ = _problem(12, shape)
    wt = _torch_weight(k)
    plan = deconv.tile_plan(n, h, w, cin, cout, elem_bytes)
    assert len(plan.flat()) == deconv.PLAN_LEN
    # TMA's rules: 16-byte strides, a 128-byte swizzled row per box row, at
    # most TILE_M pixels and 256 elements a box dim.
    assert all(st % 16 == 0 for st in plan.a_strides + plan.b_strides)
    assert plan.kc * elem_bytes == deconv.ROW_BYTES
    assert plan.bw * plan.rows * plan.imgs <= deconv.TILE_M
    assert max(plan.a_box + plan.b_box) <= 256
    got = _emulate_tile_walk(torch.from_numpy(x), deconv.pack_weight(wt), plan)
    ref = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), wt, stride=2, padding=1)
    assert not torch.isnan(got).any()  # every output written
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-4)


def test_packed_operands_on_cpu_match_raw_wrappers():
    """The packed entry points take the plain version on the CPU, on the
    raw operands they carry, and count no launch."""
    x, k, bn = _problem(13, SHAPES[1])
    scale, bias = _folds(bn)
    w = _torch_weight(k)
    wq, ws = deconv.quantize_deconv_weight(w)
    xt = torch.from_numpy(x)
    sx = torch.tensor(np.abs(x).max() / 127.0, dtype=torch.float32)
    kernels.reset_launch_counts()
    ops3 = deconv.pack_k3(w, scale, bias, torch.float32)
    ops4 = deconv.pack_k4(wq, ws, scale, bias)
    assert torch.equal(ops3.wpk, deconv.pack_weight(w)) and torch.equal(ops4.wpk, deconv.pack_weight(wq))
    assert not ops3.wpk.requires_grad and ops4.wpk.dtype == torch.int8
    torch.testing.assert_close(deconv.fused_deconv_bn_relu_packed(xt, ops3),
                               deconv.fused_deconv_bn_relu(xt, w, scale, bias), rtol=0, atol=0)
    torch.testing.assert_close(deconv.fused_deconv_bn_relu_int8_packed(xt, ops4, sx),
                               deconv.fused_deconv_bn_relu_int8(xt, wq, ws, scale, bias, sx),
                               rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}


# Packed operands that do not fit x or each other: the kernel would read
# past their ends, so the packed entry points refuse them on any device.
MISMATCHES = {
    "wpk_of_another_layer": lambda ops, other: ops._replace(wpk=other.wpk),
    "wpk_not_contiguous": lambda ops, other: ops._replace(
        wpk=ops.wpk.transpose(0, 2).contiguous().transpose(0, 2)),
    "scale_short": lambda ops, other: ops._replace(scale=ops.scale[:-8]),
    "bias_of_another_layer": lambda ops, other: ops._replace(bias=other.bias),
}


@pytest.mark.parametrize("int8", [False, True], ids=["k3", "k4"])
@pytest.mark.parametrize("mismatch", sorted(MISMATCHES))
def test_packed_entry_points_refuse_mismatched_operands(mismatch, int8):
    x, k, bn = _problem(14, SHAPES[1])
    _, k_other, bn_other = _problem(15, (1, 2, 2, 96, 128))  # same Cin, Cout 128
    xt = torch.from_numpy(x)
    sx = torch.tensor(np.abs(x).max() / 127.0, dtype=torch.float32)

    def ops_of(kk, bb):
        w = _torch_weight(kk)
        if int8:
            return deconv.pack_k4(*deconv.quantize_deconv_weight(w), *_folds(bb))
        return deconv.pack_k3(w, *_folds(bb), torch.float32)

    ops = MISMATCHES[mismatch](ops_of(k, bn), ops_of(k_other, bn_other))
    with pytest.raises(ValueError):
        if int8:
            deconv.fused_deconv_bn_relu_int8_packed(xt, ops, sx)
        else:
            deconv.fused_deconv_bn_relu_packed(xt, ops)


def test_ws_mismatch_refused_by_k4():
    x, k, bn = _problem(16, SHAPES[1])
    ops = deconv.pack_k4(*deconv.quantize_deconv_weight(_torch_weight(k)), *_folds(bn))
    with pytest.raises(ValueError):
        deconv.fused_deconv_bn_relu_int8_packed(
            torch.from_numpy(x), ops._replace(ws=ops.ws[:-8]), torch.tensor(0.1))


def test_c_plan_struct_matches_tile_plan():
    """csrc/deconv.cu's ``struct Plan`` has TilePlan's fields, in order and
    of the same lengths, and PLAN_LEN int64s in all (the C entry points
    refuse a plan of another length)."""
    src = open(os.path.join(_build.CSRC, "deconv.cu")).read()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"long long ([^;]*);", body):
        for item in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", item)
            fields.append((m.group(1), int(m.group(2) or 1)))
    plan = deconv.tile_plan(2, 5, 7, 72, 64, 2)
    assert [f for f, _ in fields] == list(deconv.TilePlan._fields)
    assert [n for _, n in fields] == [len(v) if isinstance(v, tuple) else 1 for v in plan]
    assert sum(n for _, n in fields) == deconv.PLAN_LEN == len(plan.flat())


@pytest.fixture(scope="module")
def flax_resnet18():
    model = FlaxPoseResNet(num_joints=5, num_layers=18, dtype=jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    return model, variables, x


def test_head_matches_jax_head(flax_resnet18):
    """trunk + apply_pose_resnet_head against the JAX package's, on the same
    weights (the TPU.PALLAS_HEAD forward of both engines)."""
    model, variables, x = flax_resnet18
    trunk = model.apply(variables, jnp.asarray(x), train=False, skip_head=True)
    ref = np.asarray(jax_deconv.apply_pose_resnet_head(
        trunk, variables["params"], variables["batch_stats"], interpret=True))
    port = PoseResNet(5, 18).eval()
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]), strict=True)
    with torch.no_grad():
        t = port(torch.from_numpy(x).permute(0, 3, 1, 2), skip_head=True)
        got = deconv.apply_pose_resnet_head(t, port, deconv.pack_pose_resnet_head(port, t.dtype))
        standard = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 5, 16, 16) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), standard.numpy(), rtol=1e-4, atol=1e-4)


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    x, k, bn = _problem(8, SHAPES[1])
    scale, bias = _folds(bn)
    w = _torch_weight(k)
    wq, ws = deconv.quantize_deconv_weight(w)
    kernels.reset_launch_counts()
    xt = torch.from_numpy(x)
    torch.testing.assert_close(deconv.fused_deconv_bn_relu(xt, w, scale, bias),
                               deconv.fused_deconv_bn_relu_plain(xt, w, scale, bias),
                               rtol=0, atol=0)
    sx = torch.tensor(1.0)
    torch.testing.assert_close(deconv.fused_deconv_bn_relu_int8(xt, wq, ws, scale, bias, sx),
                               deconv.fused_deconv_bn_relu_int8_plain(xt, wq, ws, scale, bias, sx),
                               rtol=0, atol=0)
    counts = kernels.launch_counts()
    assert counts["fused_deconv_bn_relu"] == counts["fused_deconv_bn_relu_int8"] == 0


def test_wrappers_refuse_what_they_do_not_take():
    x, k, bn = _problem(8, SHAPES[1])
    scale, bias = _folds(bn)
    w = _torch_weight(k)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError):
        deconv.fused_deconv_bn_relu(xt.permute(0, 3, 1, 2), w, scale, bias)  # NCHW
    with pytest.raises(TypeError):
        deconv.fused_deconv_bn_relu(xt.to(torch.float16), w, scale, bias)
    with pytest.raises(TypeError):
        deconv.fused_deconv_bn_relu_int8(xt, w, scale, scale, bias, torch.tensor(1.0))
    with pytest.raises(RuntimeError, match="no path"):
        deconv.fused_deconv_bn_relu(xt.to("meta"), w.to("meta"), scale, bias)
    with pytest.raises(ValueError, match="8"):
        deconv._check_cuda(xt[..., :90], 64, "k")  # Cin % 8
    with pytest.raises(ValueError, match="lie on"):
        deconv._check_cuda(xt.to("meta"), 64, "k", w)  # weights on another device


def test_kernels_registry_lists_k3_and_k4():
    assert kernels.KERNELS["fused_deconv_bn_relu"] is deconv.fused_deconv_bn_relu
    assert kernels.KERNELS["fused_deconv_bn_relu_int8"] is deconv.fused_deconv_bn_relu_int8
