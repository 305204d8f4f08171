"""K5, the int8 conv unit (kernels/int8_conv.py, csrc/int8_conv.cu), on the CPU.

  * The registered operator ``torch.ops.mval.int8_conv_bn`` on the CPU is
    the plain twin, equal bit for bit to the int8 backbones' composition as
    it stood before the unit was fused (copied below as ``_composition``):
    quantize, im2col, ``int8_matmul``, the float32 BN epilogue, ReLU, bf16,
    the residual's add and ReLU.  The same for whole PoseResNet and HRNet
    forwards against that composition's blocks.
  * The kernel's plan (``conv_plan``) at every conv shape of PoseResNet-50
    and HRNet-W32 at 256x256 and B = 16 x 31 crops, walked in Python: every
    output element in one tile, every tap's box at the conv's input pixels
    (stride and pad included), TMA's limits, the channel padding zero.
  * The tile walk emulated from the plan at small shapes (the pre-pass, the
    TMA boxes with element strides and zero fill, the K loop, the masked
    epilogue) equal to the twin.
  * ``torch.export`` of a small int8 PoseResNet-18: the fake implementation's
    shapes, one operator call a conv.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_view_active_learning_tpu_torch import kernels
from multi_view_active_learning_tpu_torch.kernels import _build, int8_conv
from multi_view_active_learning_tpu_torch.models import quantize as tq
from multi_view_active_learning_tpu_torch.models.hrnet import PoseHighResolutionNet
from multi_view_active_learning_tpu_torch.models.pose_resnet import PoseResNet
from multi_view_active_learning_tpu_torch.ops.int8 import int8_matmul

BF16 = torch.bfloat16


# -- the composition the unit replaced, as it stood (models/quantize.py) -----


def _composition(x, wq, ws, scale, bias, sx, residual, stride, pad, relu):
    xq = torch.clamp(torch.round(x.to(torch.float32) / sx), -127, 127).to(torch.int8)
    k = wq.shape[1]
    if k == 1 and pad == (0, 0):
        cols = xq[:, ::stride, ::stride, :]
    else:
        xp = F.pad(xq, (0, 0, pad[0], pad[1], pad[0], pad[1]))
        n, hp, wp, _ = xp.shape
        ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
        cols = torch.stack([xp[:, ky:ky + stride * (ho - 1) + 1:stride,
                               kx:kx + stride * (wo - 1) + 1:stride, :]
                            for ky in range(k) for kx in range(k)], dim=3).reshape(n, ho, wo, -1)
    n, ho, wo, depth = cols.shape
    acc = int8_matmul(cols.reshape(n * ho * wo, depth), wq.reshape(wq.shape[0], depth))
    acc = acc.reshape(n, ho, wo, -1)
    y = acc.to(torch.float32) * (sx * ws * scale) + bias
    if relu:
        y = torch.relu(y)
    y = y.to(BF16)
    if residual is not None:
        y = torch.relu(y.to(torch.float32) + residual.to(torch.float32)).to(BF16)
    return y


def _unit(seed, n, h, w, cin, cout, k, stride, pad, residual, sx=None):
    """Seeded operands of one unit; x exact in bf16."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((n, h, w, cin), generator=g) * 2.0).to(BF16)
    wq, ws = tq._quant_weight(torch.randn((cout, cin, k, k), generator=g))
    wq = wq.permute(0, 2, 3, 1).contiguous()
    scale = torch.rand(cout, generator=g) + 0.5
    bias = torch.randn(cout, generator=g) * 0.1
    if sx is None:
        sx = torch.amax(torch.abs(x.float())) / 127.0
    ho, wo = int8_conv.out_hw(h, w, k, stride, pad)
    res = (torch.randn((n, ho, wo, cout), generator=g)).to(BF16) if residual else None
    return x, wq, ws, scale, bias, torch.as_tensor(sx, dtype=torch.float32), res


# (n, h, w, cin, cout, k, stride, pad): every kind of unit the backbones run,
# at small sizes: 1x1 stride 1 and 2, 3x3 stride 1 and 2 (odd maps too),
# the 7x7 stem on 3 channels, the space-to-depth stem (4x4 over 12 channels
# padded (2, 1)), HRNet's 3x3 stride-2 stem, Cin not a multiple of 16.
UNITS = [
    (2, 9, 9, 16, 32, 1, 1, (0, 0)),
    (2, 9, 9, 32, 64, 1, 2, (0, 0)),
    (2, 9, 9, 16, 24, 3, 1, (1, 1)),
    (2, 9, 9, 16, 8, 3, 2, (1, 1)),
    (2, 10, 12, 64, 64, 3, 2, (1, 1)),
    (2, 20, 20, 3, 16, 7, 2, (3, 3)),
    (2, 10, 10, 12, 16, 4, 1, (2, 1)),
    (2, 16, 16, 3, 64, 3, 2, (1, 1)),
    (1, 5, 7, 72, 264, 3, 1, (1, 1)),
    (1, 2, 2, 8, 8, 3, 1, (1, 1)),
]


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("unit", UNITS, ids=str)
def test_operator_on_cpu_is_the_composition_bit_for_bit(unit, relu, residual):
    n, h, w, cin, cout, k, stride, pad = unit
    x, wq, ws, scale, bias, sx, res = _unit(sum(unit[:6]), n, h, w, cin, cout, k, stride, pad,
                                            residual)
    got = torch.ops.mval.int8_conv_bn(x, wq, ws, scale, bias, sx, res, stride, pad[0], pad[1], relu)
    ref = _composition(x, wq, ws, scale, bias, sx, res, stride, pad, relu)
    assert got.dtype == BF16 and got.shape == ref.shape
    assert torch.equal(got, ref)
    via_wrapper = int8_conv.int8_conv_bn(x, wq, ws, scale, bias, sx, res, stride, pad, relu)
    assert torch.equal(via_wrapper, ref)


@pytest.mark.parametrize("unit", [UNITS[0], UNITS[3], UNITS[5]], ids=str)
def test_empty_batch_gives_an_empty_output(unit):
    n, h, w, cin, cout, k, stride, pad = unit
    x, wq, ws, scale, bias, sx, res = _unit(5, n, h, w, cin, cout, k, stride, pad, True)
    got = int8_conv.int8_conv_bn(x[:0], wq, ws, scale, bias, sx, res[:0], stride, pad)
    assert got.dtype == BF16 and got.shape == (0,) + res.shape[1:]


def test_static_scale_that_clips_is_the_composition():
    """A static scale well under the input's: the clip to +-127 binds."""
    x, wq, ws, scale, bias, _, res = _unit(3, 2, 9, 9, 16, 24, 3, 1, (1, 1), True)
    sx = torch.tensor(0.004)
    got = int8_conv.int8_conv_bn(x, wq, ws, scale, bias, sx, res, 1)
    assert torch.equal(got, _composition(x, wq, ws, scale, bias, sx, res, 1, (1, 1), True))


# -- whole forwards against the composition's blocks --------------------------


def _composition_qconv(x, qp, conv, bn, scales, name, stride=1, relu=True, residual=None):
    sx = scales.scale_for(name, x)
    wq = qp[conv + ".wq"]
    k = wq.shape[1]
    y = _composition(x, wq, qp[conv + ".ws"], qp[bn + ".scale"], qp[bn + ".bias"], sx, None,
                     stride, (k // 2, k // 2), relu)
    return y if residual is None else tq._residual_relu(y, residual)


def _composition_stem(x, wq, ws, scale, bias, sx, residual=None, stride=1, pad=None, relu=True):
    k = wq.shape[1]
    return _composition(x, wq, ws, scale, bias, sx, residual, stride,
                        (k // 2, k // 2) if pad is None else tuple(pad), relu)


def _basic_block(x, qp, conv_bn, scales, tname, prefix, stride, downsample):
    out = conv_bn(x, qp, tname + ".conv1", tname + ".bn1", scales, prefix + "/conv1", stride)
    out = conv_bn(out, qp, tname + ".conv2", tname + ".bn2", scales, prefix + "/conv2",
                  relu=False)
    residual = x
    if downsample:
        residual = conv_bn(x, qp, tname + ".downsample.0", tname + ".downsample.1", scales,
                           prefix + "/down", stride, relu=False)
    return tq._residual_relu(out, residual)


def _bottleneck_block(x, qp, conv_bn, scales, tname, prefix, stride, downsample):
    out = conv_bn(x, qp, tname + ".conv1", tname + ".bn1", scales, prefix + "/conv1")
    out = conv_bn(out, qp, tname + ".conv2", tname + ".bn2", scales, prefix + "/conv2", stride)
    out = conv_bn(out, qp, tname + ".conv3", tname + ".bn3", scales, prefix + "/conv3",
                  relu=False)
    residual = x
    if downsample:
        residual = conv_bn(x, qp, tname + ".downsample.0", tname + ".downsample.1", scales,
                           prefix + "/down", stride, relu=False)
    return tq._residual_relu(out, residual)


@pytest.fixture
def composition(monkeypatch):
    """The int8 forwards with every K5 unit replaced by the composition, and
    the blocks as they stood (the residual's add and ReLU after the block's
    convs and its downsample)."""
    monkeypatch.setattr(tq, "_qconv_bn", _composition_qconv)
    monkeypatch.setattr(tq.int8_conv, "int8_conv_bn", _composition_stem)
    monkeypatch.setattr(tq, "_basic_block", _basic_block)
    monkeypatch.setattr(tq, "_bottleneck_block", _bottleneck_block)
    return monkeypatch


def _seeded(model, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: (v + 0.1 * torch.randn(v.shape, generator=g)) if v.dtype.is_floating_point else v
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("depth,s2d", [(18, False), (50, False), (18, True)],
                         ids=["resnet18", "resnet50", "resnet18_s2d"])
def test_pose_resnet_forward_equals_the_composition(depth, s2d, composition):
    from multi_view_active_learning_tpu_torch.models.pose_resnet import space_to_depth

    qp = tq.quantize_state_dict(_seeded(PoseResNet(5, depth), depth), depth)
    x = torch.randn(2, 32, 32, 3)
    if s2d:
        x = space_to_depth(x)
    kernels.reset_launch_counts()
    ref, table = tq.quantized_pose_resnet_forward(qp, x, depth, collect_scales=True)
    ref_static = tq.quantized_pose_resnet_forward(qp, x, depth, act_scales=table)
    composition.undo()
    got, got_table = tq.quantized_pose_resnet_forward(qp, x, depth, collect_scales=True)
    got_static = tq.quantized_pose_resnet_forward(qp, x, depth, act_scales=got_table)
    assert torch.equal(got, ref) and torch.equal(got_static, ref_static)
    assert set(got_table) == set(table) and all(torch.equal(got_table[k], table[k]) for k in table)
    assert kernels.launch_counts()["int8_conv_bn"] == 0  # the CPU launches nothing


def test_hrnet_forward_equals_the_composition(composition):
    stages = dict(stage2=(1, 2, "BASIC", (1, 1), (16, 32)),
                  stage3=(1, 3, "BASIC", (1, 1, 1), (16, 32, 64)),
                  stage4=(1, 4, "BASIC", (1, 1, 1, 1), (16, 32, 64, 128)))
    qp = tq.quantize_state_dict(_seeded(PoseHighResolutionNet(4, **stages), 7), 0,
                                model_type="HRNET")
    x = torch.randn(2, 32, 32, 3)
    ref, table = tq.quantized_hrnet_forward(qp, x, **stages, collect_scales=True)
    composition.undo()
    got, got_table = tq.quantized_hrnet_forward(qp, x, **stages, collect_scales=True)
    assert torch.equal(got, ref)
    assert set(got_table) == set(table)


# -- the plan at the backbones' full-size shapes ------------------------------

CROPS, IMG = 16 * 31, 256


def _units_of(forward):
    """Every K5 unit a forward calls, as (n, h, w, cin, cout, k, stride, pad,
    relu, residual), from a forward on meta tensors."""
    seen = []

    def record(x, wq, ws, scale, bias, act_scale, residual=None, stride=1, pad=None, relu=True):
        k = wq.shape[1]
        pad = (k // 2, k // 2) if pad is None else tuple(pad)
        seen.append((*x.shape, wq.shape[0], k, stride, pad, relu, residual is not None))
        ho, wo = int8_conv.out_hw(x.shape[1], x.shape[2], k, stride, pad)
        return torch.empty((x.shape[0], ho, wo, wq.shape[0]), dtype=BF16, device="meta")

    real = int8_conv.int8_conv_bn
    int8_conv.int8_conv_bn = record
    try:
        forward()
    finally:
        int8_conv.int8_conv_bn = real
    return seen


def _meta_qp(model, **kw):
    sd = {k: v.to("meta") for k, v in model.state_dict().items()}
    return tq.quantize_state_dict(sd, **kw)


@pytest.fixture(scope="module")
def backbone_units():
    """PoseResNet-50's and HRNet-W32's units at 256x256 and B = 16 x 31."""
    x = torch.empty((CROPS, IMG, IMG, 3), device="meta")
    qp = _meta_qp(PoseResNet(19, 50), num_layers=50)
    resnet = _units_of(lambda: tq.quantized_pose_resnet_forward(qp, x, 50))
    hr = PoseHighResolutionNet(19)
    hqp = _meta_qp(hr, num_layers=0, model_type="HRNET")
    hrnet = _units_of(lambda: tq.quantized_hrnet_forward(hqp, x, *hr.stage_configs))
    return {"POSE_RESNET": resnet, "HRNET": hrnet}


def test_the_backbones_units(backbone_units):
    """PoseResNet-50: 53 convs, 16 with a residual (one a bottleneck), the
    stem on 3 channels; HRNet-W32's 3x3 stride-2 stem gathers its taps too."""
    resnet = backbone_units["POSE_RESNET"]
    assert len(resnet) == 53 and sum(u[-1] for u in resnet) == 16
    assert resnet[0] == (CROPS, IMG, IMG, 3, 64, 7, 2, (3, 3), True, False)
    hrnet = backbone_units["HRNET"]
    assert hrnet[0][3] == 3 and hrnet[1][3] == 64 and len(set(hrnet)) > 20


def _walk(plan):
    """The plan's tiles over the product's grid, vectorized: asserts every
    output pixel and channel lies in exactly one tile, and returns for each
    (tile, box position) the output pixel (gn, gh, gw index) or -1."""
    t = np.arange(plan.tiles, dtype=np.int64)
    nt, mt = t % plan.n_tiles, t // plan.n_tiles
    jb, rest = mt % plan.j_tiles, mt // plan.j_tiles
    ib, nb = rest % plan.i_tiles, rest // plan.i_tiles
    # tile_coords is the same walk.
    for probe in {0, plan.tiles - 1, plan.tiles // 3}:
        assert int8_conv.tile_coords(plan, probe) == (
            nb[probe] * plan.imgs, ib[probe] * plan.rows, jb[probe] * plan.bw, nt[probe] * plan.tile_n)
    assert nb.max() * plan.imgs < plan.gn and ib.max() * plan.rows < plan.gh
    # Each pixel tile appears once per Cout tile; the Cout tiles cover Cout.
    assert plan.n_tiles * plan.tile_n >= plan.cout > (plan.n_tiles - 1) * plan.tile_n
    first = mt[nt == 0]
    p = np.arange(plan.bw * plan.rows * plan.imgs)
    img, rem = p // (plan.bw * plan.rows), p % (plan.bw * plan.rows)
    r, c = rem // plan.bw, rem % plan.bw
    n = (first // (plan.j_tiles * plan.i_tiles))[:, None] * plan.imgs + img
    i = ((first // plan.j_tiles) % plan.i_tiles)[:, None] * plan.rows + r
    j = (first % plan.j_tiles)[:, None] * plan.bw + c
    inside = (n < plan.gn) & (i < plan.gh) & (j < plan.gw)
    flat = (n * plan.gh + i) * plan.gw + j
    counts = np.bincount(flat[inside], minlength=plan.gn * plan.gh * plan.gw)
    assert counts.min() == 1 and counts.max() == 1
    return first, n, i, j, inside


def _check_plan(unit):
    n, h, w, cin, cout, k, stride, pad, relu, _ = unit
    plan = int8_conv.conv_plan(n, h, w, cin, cout, k, stride, pad[0], pad[1], relu)
    ho, wo = int8_conv.out_hw(h, w, k, stride, pad)
    assert (plan.ho, plan.wo) == (ho, wo) and len(plan.flat()) == int8_conv.PLAN_LEN
    # TMA's rules: 16-byte strides under 2^40, dims under 2^32, boxes of 1
    # to 256 elements, 128 bytes of channels a box row, element strides 1-8.
    assert all(s % 16 == 0 and s < 2**40 for s in plan.a_strides + plan.b_strides)
    assert all(0 < d < 2**32 for d in plan.a_dims + plan.b_dims)
    assert all(0 < b <= 256 for b in plan.a_box + plan.b_box)
    assert plan.kc == int8_conv.ROW_BYTES == plan.a_box[0] == plan.b_box[0]
    assert all(1 <= e <= 8 for e in plan.a_estr) and plan.a_estr[0] == 1
    loaded = [-(-b // e) for b, e in zip(plan.a_box, plan.a_estr)]
    assert loaded == [plan.kc, plan.bw, plan.rows, plan.imgs]
    assert plan.a_bytes == plan.kc * plan.bw * plan.rows * plan.imgs
    assert plan.bw * plan.rows * plan.imgs <= int8_conv.TILE_M
    # Channels: q's padded to 16 with zeros (the pre-pass writes them, TMA
    # fills past cin_a), the K loop covers every channel of q, the B map's
    # rows are the same channels.
    depth = k * k * cin if plan.im2col else cin
    assert plan.cin_a == -(-depth // 16) * 16 and plan.a_dims[0] == plan.b_dims[0] == plan.cin_a
    assert plan.chunks * plan.kc >= plan.cin_a > (plan.chunks - 1) * plan.kc
    assert plan.im2col == (cin < int8_conv.IM2COL_BELOW)
    assert plan.tile_n == int8_conv.tile_n_for(cout) and plan.b_dims[1:3] == (plan.taps, cout)
    # Every output element in exactly one tile.
    first, on, oi, oj, inside = _walk(plan)
    assert plan.gn * plan.gh * plan.gw == n * ho * wo
    # Every tap's box reads the conv's input pixels: box element (img, r, c)
    # of tap (ky, kx) lies at the box start plus (r, c) element strides, and
    # that is input pixel (i * stride + ky - pad, j * stride + kx - pad) of
    # output pixel (i, j); what lies outside q is the pad (read as zero).
    if plan.gn * plan.gh == 1:  # one row of all pixels: q row = output pixel
        assert plan.a_dims[1] == n * ho * wo and plan.taps == 1 and plan.gstride == 1
        return plan
    assert plan.a_dims[1:] == (w, h, n) and (plan.gk, plan.gstride, plan.gpad) == (k, stride, pad[0])
    i0 = ((first // plan.j_tiles) % plan.i_tiles) * plan.rows
    j0 = (first % plan.j_tiles) * plan.bw
    p = np.arange(plan.bw * plan.rows * plan.imgs)
    r, c = (p % (plan.bw * plan.rows)) // plan.bw, p % plan.bw
    for ky, kx in {(0, 0), (k - 1, k - 1), (k // 2, 0)}:
        start_h = i0 * plan.gstride + ky - plan.gpad
        start_w = j0 * plan.gstride + kx - plan.gpad
        got_h = start_h[:, None] + r * plan.a_estr[2]
        got_w = start_w[:, None] + c * plan.a_estr[1]
        want_h, want_w = oi * stride + ky - pad[0], oj * stride + kx - pad[0]
        assert np.array_equal(got_h[inside], want_h[inside])
        assert np.array_equal(got_w[inside], want_w[inside])
        # ... inside the padded input: what lies outside x is the zero pad.
        assert want_h[inside].min() >= -pad[0] and want_h[inside].max() < h + pad[1]
        assert want_w[inside].min() >= -pad[0] and want_w[inside].max() < w + pad[1]
    return plan


@pytest.mark.parametrize("model", ["POSE_RESNET", "HRNET"])
def test_plan_walks_every_full_size_unit(backbone_units, model):
    plans = {}
    for unit in sorted(set(backbone_units[model])):
        plans[unit] = _check_plan(unit)
    # The wide early layers and the deep late ones take different tiles
    # from the same algorithm.
    assert {p.tile_n for p in plans.values()} == {64, 128, 256}
    assert any(p.im2col for p in plans.values())


# -- the kernel's tile walk emulated from the plan ----------------------------


def _tma_box(t, start, box, estr):
    """What a TMA load reads: from ``t`` (dims innermost last, the map's
    reversed), ceil(box / estr) elements a dim, `estr` apart, from `start`
    (innermost first); zeros outside ``t``."""
    shape = [-(-b // e) for b, e in zip(box, estr)]
    out = t.new_zeros(tuple(reversed(shape)))
    idx = []
    for d, (s, cnt, e) in enumerate(zip(start, shape, estr)):
        size = t.shape[t.dim() - 1 - d]
        pos = s + e * torch.arange(cnt)
        idx.append((pos, (pos >= 0) & (pos < size)))
    sel = [pos.clamp(0, t.shape[t.dim() - 1 - d] - 1) for d, (pos, _) in enumerate(idx)]
    ok = idx[3][1][:, None, None, None] & idx[2][1][None, :, None, None] \
        & idx[1][1][None, None, :, None] & idx[0][1][None, None, None, :]
    vals = t[sel[3][:, None, None, None], sel[2][None, :, None, None],
             sel[1][None, None, :, None], sel[0][None, None, None, :]]
    return torch.where(ok, vals, out)


def _emulate(x, wq, ws, scale, bias, sx, residual, stride, pad, relu):
    """csrc/int8_conv.cu from the plan, in plain tensors: the pre-pass, every
    tile's K loop of A and B boxes, the masked epilogue and store."""
    n, h, w, cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    plan = int8_conv.conv_plan(n, h, w, cin, cout, k, stride, pad[0], pad[1], relu)
    xq = tq._quant_act(x, sx)
    if plan.im2col:
        cols = int8_conv.im2col(xq, k, stride, pad).reshape(n * plan.ho * plan.wo, -1)
        q = F.pad(cols, (0, plan.cin_a - cols.shape[1]))
    else:
        q = F.pad(xq, (0, plan.cin_a - cin))
    assert tuple(q.shape) == plan.q_shape
    assert bool((q[..., depth_of(plan):] == 0).all())  # the channel padding is zero
    qa = q.reshape(tuple(reversed(plan.a_dims))).to(torch.float64)
    wb = int8_conv.pack_weight(wq, plan).reshape(tuple(reversed(plan.b_dims))).to(torch.float64)
    out = torch.full((n * plan.ho * plan.wo, cout), float("nan"), dtype=torch.float64)
    box = plan.bw * plan.rows * plan.imgs
    mult = sx * ws * scale
    for tile in range(plan.tiles):
        n0, i0, j0, co0 = int8_conv.tile_coords(plan, tile)
        acc = torch.zeros((int8_conv.TILE_M, plan.tile_n), dtype=torch.float64)
        for kt in range(plan.taps * plan.chunks):
            tap, chunk = divmod(kt, plan.chunks)
            ky, kx = divmod(tap, plan.gk)
            ci = chunk * plan.kc
            a = _tma_box(qa, (ci, j0 * plan.gstride + kx - plan.gpad,
                              i0 * plan.gstride + ky - plan.gpad, n0), plan.a_box, plan.a_estr)
            b = _tma_box(wb, (ci, tap, co0, 0), plan.b_box, (1, 1, 1, 1))
            acc[:box] += a.reshape(box, plan.kc) @ b.reshape(plan.tile_n, plan.kc).t()
        cols = min(plan.tile_n, cout - co0)
        y = acc[:, :cols].to(torch.int32).to(torch.float32) * mult[co0:co0 + cols] + bias[co0:co0 + cols]
        if relu:
            y = torch.relu(y)
        y = y.to(BF16)
        for p in range(box):
            img, rem = divmod(p, plan.bw * plan.rows)
            row, col = divmod(rem, plan.bw)
            nn, i, j = n0 + img, i0 + row, j0 + col
            if nn < plan.gn and i < plan.gh and j < plan.gw:
                out[(nn * plan.gh + i) * plan.gw + j, co0:co0 + cols] = y[p].to(torch.float64)
    assert not torch.isnan(out).any()  # every output written
    y = out.to(BF16).reshape(n, plan.ho, plan.wo, cout)
    return y if residual is None else tq._residual_relu(y, residual)


def depth_of(plan):
    return plan.k * plan.k * plan.cin if plan.im2col else plan.cin


# The emulated units: the kinds of UNITS, plus a Cout over one 256 tile, a
# row wider than a tile (two column tiles) and a 128-tile-deep gathered stem.
WALK_UNITS = UNITS[:8] + [(1, 3, 3, 16, 264, 3, 1, (1, 1)), (1, 2, 130, 16, 8, 3, 2, (1, 1)),
                          (1, 8, 130, 16, 16, 1, 1, (0, 0))]


@pytest.mark.parametrize("unit", WALK_UNITS, ids=str)
def test_tile_walk_reproduces_the_twin(unit):
    n, h, w, cin, cout, k, stride, pad = unit
    relu = bool(sum(unit[:5]) % 2)
    x, wq, ws, scale, bias, sx, res = _unit(7 + sum(unit[:6]), n, h, w, cin, cout, k, stride, pad,
                                            cout % 16 == 0)
    got = _emulate(x, wq, ws, scale, bias, sx, res, stride, pad, relu)
    ref = int8_conv.int8_conv_bn_plain(x, wq, ws, scale, bias, sx, res, stride, pad, relu)
    assert torch.equal(got, ref)


def test_c_plan_struct_matches_conv_plan():
    """csrc/int8_conv.cu's ``struct Plan`` has ConvPlan's fields, in order and
    of the same lengths, and PLAN_LEN int64s in all (the C entry point
    refuses a plan of another length)."""
    src = open(os.path.join(_build.CSRC, "int8_conv.cu")).read()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"long long ([^;]*);", body):
        for item in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", item)
            fields.append((m.group(1), int(m.group(2) or 1)))
    plan = int8_conv.conv_plan(2, 9, 9, 16, 24, 3, 2, 1, 1, True)
    assert [f for f, _ in fields] == list(int8_conv.ConvPlan._fields)
    assert [c for _, c in fields] == [len(v) if isinstance(v, tuple) else 1 for v in plan]
    assert sum(c for _, c in fields) == int8_conv.PLAN_LEN == len(plan.flat())
    assert "mval_int8_conv_bn" in _build.SIGNATURES


# -- registration, export, refusals -------------------------------------------


def test_kernels_registry_lists_k5_and_the_cpu_launches_nothing():
    assert kernels.KERNELS["int8_conv_bn"] is int8_conv.int8_conv_bn
    x, wq, ws, scale, bias, sx, res = _unit(1, *UNITS[2][:7], UNITS[2][7], True)
    kernels.reset_launch_counts()
    int8_conv.int8_conv_bn(x, wq, ws, scale, bias, sx, res)
    assert kernels.launch_counts()["int8_conv_bn"] == 0


def test_operator_passes_opcheck():
    x, wq, ws, scale, bias, sx, res = _unit(2, *UNITS[3][:7], UNITS[3][7], True)
    torch.library.opcheck(torch.ops.mval.int8_conv_bn, (x, wq, ws, scale, bias, sx, res, 2, 1, 1, False))
    torch.library.opcheck(torch.ops.mval.int8_conv_bn, (x, wq, ws, scale, bias, sx, None, 2, 1, 1, True))


def test_wrapper_refuses_what_it_does_not_take():
    x, wq, ws, scale, bias, sx, res = _unit(4, 2, 9, 9, 16, 24, 3, 1, (1, 1), True)
    with pytest.raises(ValueError):
        int8_conv.int8_conv_bn(x.permute(0, 3, 1, 2), wq, ws, scale, bias, sx)  # NCHW
    with pytest.raises(TypeError):
        int8_conv.int8_conv_bn(x, wq.float(), ws, scale, bias, sx)
    with pytest.raises(ValueError):
        int8_conv.int8_conv_bn(x, wq, ws[:-8], scale, bias, sx)
    with pytest.raises(ValueError):
        int8_conv.int8_conv_bn(x, wq, ws, scale, bias, sx, res[:, :-1])
    with pytest.raises(ValueError):
        int8_conv.int8_conv_bn(x, wq, ws, scale, bias, sx, stride=3)
    with pytest.raises(RuntimeError, match="no path"):
        int8_conv.int8_conv_bn(x.to("meta"), wq.to("meta"), ws, scale, bias, sx)
    # What the kernel takes (checked before any launch).
    with pytest.raises(TypeError, match="bf16"):
        int8_conv._check_cuda(x.float(), wq, ws, scale, bias, sx, None)
    with pytest.raises(ValueError, match="8"):
        int8_conv._check_cuda(torch.cat([x, x[..., :4]], -1), wq, ws, scale, bias, sx, None)  # Cin 20
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv._check_cuda(x.transpose(1, 2), wq, ws, scale, bias, sx, None)
    with pytest.raises(ValueError, match="lie on"):
        int8_conv._check_cuda(x, wq.to("meta"), ws, scale, bias, sx, None)


class _Int8ResNet(torch.nn.Module):
    def __init__(self, qp, scales):
        super().__init__()
        self.keys = list(qp)
        for i, key in enumerate(self.keys):
            self.register_buffer("q%d" % i, qp[key])
        self.skeys = list(scales)
        for i, key in enumerate(self.skeys):
            self.register_buffer("s%d" % i, scales[key])

    def forward(self, x):
        qp = {k: getattr(self, "q%d" % i) for i, k in enumerate(self.keys)}
        scales = {k: getattr(self, "s%d" % i) for i, k in enumerate(self.skeys)}
        return tq.quantized_pose_resnet_forward(qp, x, 18, act_scales=scales)


def test_export_of_an_int8_pose_resnet18_calls_the_operator_once_a_conv():
    qp = tq.quantize_state_dict(_seeded(PoseResNet(4, 18), 18), 18)
    x = torch.randn(2, 32, 32, 3)
    _, scales = tq.quantized_pose_resnet_forward(qp, x, 18, collect_scales=True)
    module = _Int8ResNet(qp, scales).eval()
    meta_qp = {k: v.to("meta") for k, v in qp.items()}
    meta_scales = {k: v.to("meta") for k, v in scales.items()}
    eager_units = _units_of(lambda: tq.quantized_pose_resnet_forward(
        meta_qp, x.to("meta"), 18, act_scales=meta_scales))
    ep = torch.export.export(module, (x,))
    calls = [n for n in ep.graph.nodes if str(n.target) == "mval.int8_conv_bn.default"]
    assert len(calls) == len(eager_units) == 20  # the stem, 16 block convs, 3 downsamples
    for node, unit in zip(calls, eager_units):
        n, h, w, _, cout, k, stride, pad, _, _ = unit
        ho, wo = int8_conv.out_hw(h, w, k, stride, pad)
        assert tuple(node.meta["val"].shape) == (n, ho, wo, cout)
        assert node.meta["val"].dtype == BF16
    torch.testing.assert_close(ep.module()(x), module(x), rtol=0, atol=0)
