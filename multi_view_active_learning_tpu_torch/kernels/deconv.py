"""K3 and K4: fused ConvTranspose(k4, s2, p1) + BN + ReLU (``csrc/deconv.cu``)
and their plain versions.

Replace ops/pallas/deconv.py::fused_deconv_bn_relu (K3) and
::fused_deconv_bn_relu_int8 (K4) of the JAX package, the PoseResNet deconv
head of inference.  Activations are NHWC ([N, H, W, Cin] -> [N, 2H, 2W,
Cout], as the JAX functions take them); weights are in torch's
``ConvTranspose2d`` layout [Cin, Cout, 4, 4].  Per spatial dim, with ``Xp``
the input padded by one,

    y[2m + r] = sum_{a in {0, 1}} Xp[m + r + a] * W[3 - 2a - r],

so each output phase (r, s) is a dense product over 4 taps x Cin.

  * K3 ``fused_deconv_bn_relu``: the weights are cast to x's type, the
    products accumulate in float32, and the folded BN and the ReLU act on
    the float32 accumulator before one rounding to x's type.
  * K4 ``fused_deconv_bn_relu_int8``: x is quantized per tensor with the
    reciprocal of its scale, ``round(x * (1/sx))`` clipped to +-127 (the
    backbone divides instead: models/quantize.py); the weights are s8 per
    output channel (``quantize_deconv_weight``); s32 accumulation, then
    ``acc * (sx * ws * bn_scale) + bn_bias`` and ReLU.

The kernels take their weights packed (``pack_k3`` / ``pack_k4``, once per
weight load on the engine paths, through ``fused_deconv_bn_relu_packed`` /
``fused_deconv_bn_relu_int8_packed``); the public functions on raw weights
pack per call.  ``tile_plan`` is the kernels' tiling plan (TMA maps, boxes,
tap offsets, tile counts), computed here and passed to the C entry points.
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises.  ``<kernel>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..ops.int8 import int8_matmul
from . import _build

CIN_ALIGN = 16  # csrc/deconv.cu kCinAlign: packed weights pad Cin to this
TILE_M, TILE_N, ROW_BYTES = 128, 256, 128  # csrc/deconv.cu kTileM, kTileN, kRowBytes
_KH = ((3, 1), (2, 0))  # _KH[r][a] = 3 - 2a - r, the tap of phase r
_DTYPES = (torch.bfloat16, torch.float32)


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as a per-channel affine: (scale, bias)."""
    scale = gamma / torch.sqrt(var + eps)
    return scale, beta - mean * scale


def quantize_deconv_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Cin, Cout, 4, 4] float -> (s8 weights, per-Cout float32 scale).

    The output channel of a ConvTranspose2d weight is dim 1."""
    w = weight.to(torch.float32)
    ws = torch.clamp(torch.amax(torch.abs(w), dim=(0, 2, 3)), min=1e-8) / 127.0
    wq = torch.clamp(torch.round(w / ws[None, :, None, None]), -127, 127).to(torch.int8)
    return wq, ws


def _phases(x: torch.Tensor, weight: torch.Tensor, matmul, zero_acc, epilogue):
    """The phase decomposition in plain tensor ops: for each phase, the sum
    over its four taps of ``matmul(pixels [N*H*W, Cin], tap [Cin, Cout])``,
    then ``epilogue`` and the interleave."""
    n, h, w, cin = x.shape
    cout = weight.shape[1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for r in range(2):
        for s in range(2):
            acc = zero_acc(n * h * w, cout)
            for a in range(2):
                for b in range(2):
                    xs = xp[:, r + a:r + a + h, s + b:s + b + w, :].reshape(-1, cin)
                    acc = acc + matmul(xs, weight[:, :, _KH[r][a], _KH[s][b]])
            z = epilogue(acc).reshape(n, h, w, cout)
            if out is None:
                out = z.new_empty((n, 2 * h, 2 * w, cout))
            out[:, r::2, s::2, :] = z
    return out


def fused_deconv_bn_relu_plain(x, weight, scale, bias) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch (float32 accumulation)."""
    wk = weight.to(x.dtype).to(torch.float32)
    scale, bias = scale.to(torch.float32), bias.to(torch.float32)
    return _phases(
        x, wk,
        lambda xs, wt: xs.to(torch.float32) @ wt,
        lambda m, c: torch.zeros((m, c), dtype=torch.float32, device=x.device),
        lambda acc: torch.relu(acc * scale + bias).to(x.dtype),
    )


def fused_deconv_bn_relu_int8_plain(x, wq, ws, scale, bias, act_scale) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch (exact s32 accumulation)."""
    _, inv_sx, mult = _int8_factors(ws, scale, act_scale)
    xq = torch.clamp(torch.round(x.to(torch.float32) * inv_sx), -127, 127).to(torch.int8)
    bias = bias.to(torch.float32)
    return _phases(
        xq, wq,
        lambda xs, wt: int8_matmul(xs, wt.t()),
        lambda m, c: torch.zeros((m, c), dtype=torch.int32, device=x.device),
        lambda acc: torch.relu(acc.to(torch.float32) * mult + bias).to(x.dtype),
    )


def _int8_factors(ws, scale, act_scale):
    """(sx, 1/sx, sx * ws * bn_scale), as the JAX wrapper forms them (the
    kernel forms the same values on the device, in the same order)."""
    sx = torch.clamp(torch.as_tensor(act_scale, dtype=torch.float32, device=ws.device), min=1e-8)
    return sx, 1.0 / sx, sx * ws * scale.to(torch.float32)


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """[Cin, Cout, 4, 4] -> [4 phases][Cout][4 taps][Cin_pad], K contiguous,
    Cin zero-padded to CIN_ALIGN (csrc/deconv.cu's layout).  Slices and one
    stack: no index tensor, so no host-to-device copy stalls the caller."""
    cin, cout = weight.shape[:2]
    taps = weight.permute(2, 3, 1, 0).contiguous()  # [kh, kw, Cout, Cin]
    g = torch.stack([taps[_KH[r][a], _KH[s][b]]
                     for r in range(2) for s in range(2) for a in range(2) for b in range(2)])
    g = g.reshape(4, 4, cout, cin).permute(0, 2, 1, 3)  # [phase, Cout, tap, Cin]
    return F.pad(g, (0, (-cin) % CIN_ALIGN)).contiguous()


class K3Operands(NamedTuple):
    """K3's operands for one layer: the raw weights (the plain version's),
    the folded BN in float32, and the weights packed in the activations'
    type (the kernel's)."""
    weight: torch.Tensor  # [Cin, Cout, 4, 4]
    scale: torch.Tensor  # [Cout] float32
    bias: torch.Tensor  # [Cout] float32
    wpk: torch.Tensor  # [4, Cout, 4, Cin_pad]


class K4Operands(NamedTuple):
    """K4's operands for one layer: s8 weights and their per-Cout scales
    (the plain version's), the folded BN in float32, and the packed s8
    weights (the kernel's).  The activation scale comes with each call."""
    wq: torch.Tensor  # [Cin, Cout, 4, 4] s8
    ws: torch.Tensor  # [Cout] float32
    scale: torch.Tensor  # [Cout] float32
    bias: torch.Tensor  # [Cout] float32
    wpk: torch.Tensor  # [4, Cout, 4, Cin_pad] s8


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


@torch.no_grad()
def pack_k3(weight, scale, bias, dtype: torch.dtype) -> K3Operands:
    """K3's operands for activations of ``dtype``; made once per weight load."""
    return K3Operands(weight, _f32(scale), _f32(bias), pack_weight(weight.to(dtype)))


@torch.no_grad()
def pack_k4(wq, ws, scale, bias) -> K4Operands:
    """K4's operands (``quantize_state_dict`` makes them once per load)."""
    return K4Operands(wq, _f32(ws), _f32(scale), _f32(bias), pack_weight(wq))


class TilePlan(NamedTuple):
    """csrc/deconv.cu's ``Plan``, field for field (flattened to int64 in
    this order).  dims are innermost first, strides in bytes of dims 1-3."""
    n: int
    h: int
    w: int
    cin: int
    cout: int
    cin_a: int  # channels of the A operand's tensor (x, or K4's padded s8 q)
    kc: int  # K chunk: 128 bytes of channels
    chunks: int  # K chunks per tap
    bw: int  # pixel box: bw columns x rows x imgs images, at most TILE_M pixels
    rows: int
    imgs: int
    j_tiles: int
    i_tiles: int
    n_tiles: int  # Cout tiles of TILE_N
    tiles: int  # 4 phases x pixel tiles x Cout tiles
    a_dims: Tuple[int, ...]
    a_strides: Tuple[int, ...]
    a_box: Tuple[int, ...]
    b_dims: Tuple[int, ...]
    b_strides: Tuple[int, ...]
    b_box: Tuple[int, ...]
    tap_dy: Tuple[int, ...]  # [phase * 4 + tap]: input row offset r + a - 1
    tap_dx: Tuple[int, ...]  # input column offset s + b - 1

    def flat(self) -> List[int]:
        out: List[int] = []
        for v in self:
            out.extend(v if isinstance(v, tuple) else (v,))
        return out


PLAN_LEN = 69  # int64s of csrc/deconv.cu's Plan; the C entry points check it


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_plan(n: int, h: int, w: int, cin: int, cout: int, elem_bytes: int) -> TilePlan:
    """The tiling of csrc/deconv.cu's tensor-core kernel for x [n, h, w, cin]
    and Cout channels, with operands of ``elem_bytes`` (2: K3's bf16, 1:
    K4's s8).  A tile is TILE_M pixels of one phase -- a box of whole rows
    (``imgs`` images x ``rows`` rows x ``bw`` columns) -- by TILE_N output
    channels; its K loop walks 4 taps x ``chunks`` chunks of ``kc``
    channels.  The A map spans x (K4: its s8 copy, channels padded to
    CIN_ALIGN) as [C, W, H, N], the B map the packed weights as [Cin_pad, 4
    taps, Cout, 4 phases]; the boxes are 128 bytes of channels wide, and
    TMA reads zeros outside, which is the deconv's pad of 1 and every
    ragged edge.  The kernel masks the pixels of a box outside the output."""
    cin_pad = _cdiv(cin, CIN_ALIGN) * CIN_ALIGN
    cin_a = cin_pad if elem_bytes == 1 else cin
    kc = ROW_BYTES // elem_bytes
    bw = min(w, TILE_M)
    rows = min(h, TILE_M // bw)
    imgs = min(n, TILE_M // (bw * h)) if rows == h else 1
    j_tiles, i_tiles, img_tiles = _cdiv(w, bw), _cdiv(h, rows), _cdiv(n, imgs)
    n_tiles = _cdiv(cout, TILE_N)
    a_row = cin_a * elem_bytes
    b_row = cin_pad * elem_bytes
    return TilePlan(
        n, h, w, cin, cout, cin_a, kc, _cdiv(cin_a, kc),
        bw, rows, imgs, j_tiles, i_tiles, n_tiles,
        4 * img_tiles * i_tiles * j_tiles * n_tiles,
        (cin_a, w, h, n), (a_row, w * a_row, h * w * a_row), (kc, bw, rows, imgs),
        (cin_pad, 4, cout, 4), (b_row, 4 * b_row, 4 * cout * b_row), (kc, 1, TILE_N, 1),
        tuple((p >> 1) + (t >> 1) - 1 for p in range(4) for t in range(4)),
        tuple((p & 1) + (t & 1) - 1 for p in range(4) for t in range(4)),
    )


def tile_coords(plan: TilePlan, tile: int) -> Tuple[int, int, int, int, int]:
    """Tile index -> (phase, first image, first row, first column, first
    output channel), the Cout tile fastest, then the phase (csrc/deconv.cu
    tile_coords)."""
    nt, q = tile % plan.n_tiles, tile // plan.n_tiles
    mt = q >> 2
    jb, rest = mt % plan.j_tiles, mt // plan.j_tiles
    ib, nb = rest % plan.i_tiles, rest // plan.i_tiles
    return q & 3, nb * plan.imgs, ib * plan.rows, jb * plan.bw, nt * TILE_N


def _check(x: torch.Tensor, weight: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (4, 4):
        raise ValueError("%s expects x [N, H, W, Cin] and weight [Cin, Cout, 4, 4], got %s and %s"
                         % (name, tuple(x.shape), tuple(weight.shape)))
    if x.shape[3] != weight.shape[0]:
        raise ValueError("%s: x has %d channels, weight %d" % (name, x.shape[3], weight.shape[0]))
    if x.dtype not in _DTYPES:
        raise TypeError("%s takes bfloat16 or float32 activations, got %s" % (name, x.dtype))


def _check_ops(x: torch.Tensor, ops, name: str) -> None:
    """The packed operands agree with x and with each other: the kernel's
    TMA maps and epilogue read them to the extents x and ``wpk`` give."""
    raw = ops.wq if isinstance(ops, K4Operands) else ops.weight
    _check(x, raw, name)
    cout = raw.shape[1]
    want = (4, cout, 4, _cdiv(x.shape[3], CIN_ALIGN) * CIN_ALIGN)
    if tuple(ops.wpk.shape) != want or not ops.wpk.is_contiguous():
        raise ValueError("%s: packed weights must be contiguous %s, got %s%s"
                         % (name, want, tuple(ops.wpk.shape),
                            "" if ops.wpk.is_contiguous() else " (not contiguous)"))
    vectors = ops[1:4] if isinstance(ops, K4Operands) else ops[1:3]
    for v in vectors:
        if v.dtype != torch.float32 or v.dim() != 1 or v.numel() != cout or not v.is_contiguous():
            raise ValueError("%s: per-channel operands must be contiguous float32 [%d], got %s %s"
                             % (name, cout, v.dtype, tuple(v.shape)))


def _check_device(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError("%s has no path for device %s" % (name, x.device))


def _check_cuda(x: torch.Tensor, cout: int, name: str, *operands: torch.Tensor) -> None:
    if any(t.device != x.device for t in operands):
        raise ValueError("%s: the operands lie on %s, x on %s"
                         % (name, [str(t.device) for t in operands], x.device))
    cin = x.shape[3]
    if cin % 8 or cout % 8:
        raise ValueError("%s kernel needs Cin and Cout multiples of 8, got %d and %d"
                         % (name, cin, cout))
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("%s kernel needs a contiguous, 16-byte aligned NHWC input" % name)


def launch(x: torch.Tensor, ops, act_scale=None) -> torch.Tensor:
    """Launch K3 (``ops`` a K3Operands) or K4 (a K4Operands, with the
    activation scale) on packed operands; the wrappers count launches."""
    n, h, w, cin = x.shape
    cout = ops.wpk.shape[1]
    int8 = isinstance(ops, K4Operands)
    plan = tile_plan(n, h, w, cin, cout, 1 if int8 else x.element_size())
    plan_arg = (ctypes.c_longlong * PLAN_LEN)(*plan.flat())
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if int8:
            xq = torch.empty((n, h, w, plan.cin_a), dtype=torch.int8, device=x.device)
            sx = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device).reshape(1)
            code = lib.mval_fused_deconv_bn_relu_int8(
                x.data_ptr(), xq.data_ptr(), ops.wpk.data_ptr(), sx.data_ptr(), ops.ws.data_ptr(),
                ops.scale.data_ptr(), ops.bias.data_ptr(), out.data_ptr(), plan_arg, PLAN_LEN, is_bf16,
                stream)
        else:
            code = lib.mval_fused_deconv_bn_relu(
                x.data_ptr(), ops.wpk.data_ptr(), ops.scale.data_ptr(), ops.bias.data_ptr(),
                out.data_ptr(), plan_arg, PLAN_LEN, is_bf16, stream)
    _build.check(code, "K4" if int8 else "K3")
    return out


def fused_deconv_bn_relu(x, weight, scale, bias) -> torch.Tensor:
    """relu(bn(conv_transpose(x, weight))): x [N, H, W, Cin] bf16 or f32,
    weight [Cin, Cout, 4, 4], scale/bias [Cout] (folded BN) ->
    [N, 2H, 2W, Cout] in x's type.  Packs the weights per call."""
    _check(x, weight, "fused_deconv_bn_relu")
    if x.device.type == "cpu":
        return fused_deconv_bn_relu_plain(x, weight, scale, bias)
    _check_device(x, "fused_deconv_bn_relu")
    return fused_deconv_bn_relu_packed(x, pack_k3(weight, scale, bias, x.dtype))


fused_deconv_bn_relu.launches = 0


def fused_deconv_bn_relu_packed(x, ops: K3Operands) -> torch.Tensor:
    """``fused_deconv_bn_relu`` on operands from ``pack_k3``."""
    name = "fused_deconv_bn_relu"
    _check_ops(x, ops, name)
    if x.device.type == "cpu":
        return fused_deconv_bn_relu_plain(x, ops.weight, ops.scale, ops.bias)
    _check_device(x, name)
    if ops.wpk.dtype != x.dtype:
        raise TypeError("%s: weights packed for %s, x is %s" % (name, ops.wpk.dtype, x.dtype))
    _check_cuda(x, ops.wpk.shape[1], name, *ops)
    out = launch(x, ops)
    fused_deconv_bn_relu.launches += 1
    return out


def fused_deconv_bn_relu_int8(x, wq, ws, scale, bias, act_scale) -> torch.Tensor:
    """relu(bn(conv_transpose(quant(x), wq))): x [N, H, W, Cin] bf16 or f32,
    wq [Cin, Cout, 4, 4] s8 with per-Cout scales ws (from
    ``quantize_deconv_weight``), scale/bias [Cout] (folded BN), act_scale the
    per-tensor activation scale (a scalar tensor, static or dynamic) ->
    [N, 2H, 2W, Cout] in x's type.  Packs the weights per call."""
    _check(x, wq, "fused_deconv_bn_relu_int8")
    if wq.dtype != torch.int8:
        raise TypeError("fused_deconv_bn_relu_int8 takes s8 weights, got %s" % wq.dtype)
    if x.device.type == "cpu":
        return fused_deconv_bn_relu_int8_plain(x, wq, ws, scale, bias, act_scale)
    _check_device(x, "fused_deconv_bn_relu_int8")
    return fused_deconv_bn_relu_int8_packed(x, pack_k4(wq, ws, scale, bias), act_scale)


fused_deconv_bn_relu_int8.launches = 0


def fused_deconv_bn_relu_int8_packed(x, ops: K4Operands, act_scale) -> torch.Tensor:
    """``fused_deconv_bn_relu_int8`` on operands from ``pack_k4``; the
    kernel forms 1/sx and sx * ws * bn_scale from ``act_scale`` on the
    device, so a static or dynamic scale costs no extra launch."""
    name = "fused_deconv_bn_relu_int8"
    _check_ops(x, ops, name)
    if ops.wpk.dtype != torch.int8:
        raise TypeError("%s takes s8 weights, got %s" % (name, ops.wpk.dtype))
    if x.device.type == "cpu":
        return fused_deconv_bn_relu_int8_plain(x, *ops[:4], act_scale)
    _check_device(x, name)
    _check_cuda(x, ops.wpk.shape[1], name, *ops)
    out = launch(x, ops, act_scale)
    fused_deconv_bn_relu_int8.launches += 1
    return out


def pack_pose_resnet_head(model, dtype: torch.dtype) -> List[K3Operands]:
    """K3's operands for the three deconv layers of a ``PoseResNet``."""
    layers = model.deconv_layers
    heads = []
    for i in range(3):
        conv, bn = layers[3 * i], layers[3 * i + 1]
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        heads.append(pack_k3(conv.weight, scale, bias, dtype))
    return heads


def apply_pose_resnet_head(trunk: torch.Tensor, model, heads: List[K3Operands]) -> torch.Tensor:
    """The PoseResNet deconv head through K3 (inference only).

    trunk: the model's ``skip_head=True`` output [N, C, H/32, W/32];
    model: the ``PoseResNet`` whose ``final_layer`` is read; heads: its
    ``deconv_layers`` packed by ``pack_pose_resnet_head`` in the trunk's
    type.  Returns heatmaps [N, K, H/4, W/4] float32, the contract of the
    standard head; the final 1x1 runs in float32."""
    x = trunk.permute(0, 2, 3, 1).contiguous()  # NHWC
    for ops in heads:
        x = fused_deconv_bn_relu_packed(x, ops)
    return final_1x1(x, model.final_layer.weight, model.final_layer.bias)


def final_1x1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The head's final 1x1 conv in float32: NHWC [N, h, w, C] and a Conv2d
    weight [K, C, 1, 1] -> NCHW heatmaps [N, K, h, w]."""
    y = x.to(torch.float32) @ weight[:, :, 0, 0].to(torch.float32).t() + bias.to(torch.float32)
    return y.permute(0, 3, 1, 2).contiguous()
