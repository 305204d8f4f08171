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

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.  ``<kernel>.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.int8 import int8_matmul
from . import _build

CIN_ALIGN = 64  # csrc/deconv.cu kCinAlign: packed weights pad Cin to this
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
    """(sx, 1/sx, sx * ws * bn_scale), as the JAX wrapper forms them."""
    sx = torch.clamp(torch.as_tensor(act_scale, dtype=torch.float32, device=ws.device), min=1e-8)
    return sx, 1.0 / sx, sx * ws * scale.to(torch.float32)


def _pack(weight: torch.Tensor) -> torch.Tensor:
    """[Cin, Cout, 4, 4] -> [4 phases][Cout][4 taps][Cin_pad], K contiguous,
    Cin zero-padded to CIN_ALIGN (csrc/deconv.cu's layout).  Slices and one
    stack: no index tensor, so no host-to-device copy stalls the caller."""
    cin, cout = weight.shape[:2]
    taps = weight.permute(2, 3, 1, 0).contiguous()  # [kh, kw, Cout, Cin]
    g = torch.stack([taps[_KH[r][a], _KH[s][b]]
                     for r in range(2) for s in range(2) for a in range(2) for b in range(2)])
    g = g.reshape(4, 4, cout, cin).permute(0, 2, 1, 3)  # [phase, Cout, tap, Cin]
    return F.pad(g, (0, (-cin) % CIN_ALIGN)).contiguous()


def _check(x: torch.Tensor, weight: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (4, 4):
        raise ValueError("%s expects x [N, H, W, Cin] and weight [Cin, Cout, 4, 4], got %s and %s"
                         % (name, tuple(x.shape), tuple(weight.shape)))
    if x.shape[3] != weight.shape[0]:
        raise ValueError("%s: x has %d channels, weight %d" % (name, x.shape[3], weight.shape[0]))
    if x.dtype not in _DTYPES:
        raise TypeError("%s takes bfloat16 or float32 activations, got %s" % (name, x.dtype))


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


K3_ENTRY, K4_ENTRY = "mval_fused_deconv_bn_relu", "mval_fused_deconv_bn_relu_int8"


def k3_args(x, weight, scale, bias):
    """The kernel's operands after x: packed weights in x's type, scale, bias."""
    return (_pack(weight.to(x.dtype)), scale.to(torch.float32).contiguous(),
            bias.to(torch.float32).contiguous())


def k4_args(wq, ws, scale, bias, act_scale):
    """The kernel's operands after x: packed s8 weights, 1/sx, the epilogue
    multiplier sx * ws * bn_scale, bias."""
    _, inv_sx, mult = _int8_factors(ws, scale, act_scale)
    return (_pack(wq), inv_sx.reshape(1).contiguous(), mult.contiguous(),
            bias.to(torch.float32).contiguous())


def launch(entry: str, x: torch.Tensor, args, cout: int) -> torch.Tensor:
    """Launch K3 (``K3_ENTRY``) or K4 (``K4_ENTRY``) on prepared operands
    (``k3_args`` / ``k4_args``); the wrappers count their launches."""
    n, h, w, cin = x.shape
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, entry)(
            x.data_ptr(), *[a.data_ptr() for a in args], out.data_ptr(),
            n, h, w, cin, cout, int(x.dtype == torch.bfloat16), stream,
        )
    _build.check(code, entry)
    return out


def fused_deconv_bn_relu(x, weight, scale, bias) -> torch.Tensor:
    """relu(bn(conv_transpose(x, weight))): x [N, H, W, Cin] bf16 or f32,
    weight [Cin, Cout, 4, 4], scale/bias [Cout] (folded BN) ->
    [N, 2H, 2W, Cout] in x's type."""
    _check(x, weight, "fused_deconv_bn_relu")
    if x.device.type == "cpu":
        return fused_deconv_bn_relu_plain(x, weight, scale, bias)
    if x.device.type != "cuda":
        raise RuntimeError("fused_deconv_bn_relu has no path for device %s" % x.device)
    cout = weight.shape[1]
    _check_cuda(x, cout, "fused_deconv_bn_relu", weight, scale, bias)
    out = launch(K3_ENTRY, x, k3_args(x, weight, scale, bias), cout)
    fused_deconv_bn_relu.launches += 1
    return out


fused_deconv_bn_relu.launches = 0


def fused_deconv_bn_relu_int8(x, wq, ws, scale, bias, act_scale) -> torch.Tensor:
    """relu(bn(conv_transpose(quant(x), wq))): x [N, H, W, Cin] bf16 or f32,
    wq [Cin, Cout, 4, 4] s8 with per-Cout scales ws (from
    ``quantize_deconv_weight``), scale/bias [Cout] (folded BN), act_scale the
    per-tensor activation scale (a scalar tensor, static or dynamic) ->
    [N, 2H, 2W, Cout] in x's type."""
    _check(x, wq, "fused_deconv_bn_relu_int8")
    if wq.dtype != torch.int8:
        raise TypeError("fused_deconv_bn_relu_int8 takes s8 weights, got %s" % wq.dtype)
    if x.device.type == "cpu":
        return fused_deconv_bn_relu_int8_plain(x, wq, ws, scale, bias, act_scale)
    if x.device.type != "cuda":
        raise RuntimeError("fused_deconv_bn_relu_int8 has no path for device %s" % x.device)
    cout = wq.shape[1]
    _check_cuda(x, cout, "fused_deconv_bn_relu_int8", wq, ws, scale, bias)
    out = launch(K4_ENTRY, x, k4_args(wq, ws, scale, bias, act_scale), cout)
    fused_deconv_bn_relu_int8.launches += 1
    return out


fused_deconv_bn_relu_int8.launches = 0


def apply_pose_resnet_head(trunk: torch.Tensor, model) -> torch.Tensor:
    """The PoseResNet deconv head through K3 (inference only).

    trunk: the model's ``skip_head=True`` output [N, C, H/32, W/32];
    model: the ``PoseResNet`` whose ``deconv_layers`` and ``final_layer``
    are read.  Returns heatmaps [N, K, H/4, W/4] float32, the contract of
    the standard head; the final 1x1 runs in float32."""
    x = trunk.permute(0, 2, 3, 1).contiguous()  # NHWC
    layers = model.deconv_layers
    for i in range(3):
        conv, bn = layers[3 * i], layers[3 * i + 1]
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        x = fused_deconv_bn_relu(x, conv.weight, scale, bias)
    return final_1x1(x, model.final_layer.weight, model.final_layer.bias)


def final_1x1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The head's final 1x1 conv in float32: NHWC [N, h, w, C] and a Conv2d
    weight [K, C, 1, 1] -> NCHW heatmaps [N, K, h, w]."""
    y = x.to(torch.float32) @ weight[:, :, 0, 0].to(torch.float32).t() + bias.to(torch.float32)
    return y.permute(0, 3, 1, 2).contiguous()
