"""The arithmetics the reference forwards run in.

``QuantizedScoring``: the scoring path a configuration states as int8
(TPU.INT8_SCORING with bf16 compute): every conv of the trunk quantized
symmetrically, its weights per output channel (max |w| / q) and its input
per tensor (max |x| / q over a calibration batch, or over the batch itself
when no table is given), the product summed exactly, and inference
BatchNorm folded into the rescale, ``acc * (sx * ws * scale) + bias``;
activations are kept in bfloat16 between layers, residual sums taken in
float32; the transposed-conv head in bfloat16 with its BN folded in
float32; the final 1x1 conv in float32.  ``qmax`` 127 is int8; the control
runs the same with ``qmax`` 7 (int4).  Its transformer primitives: each
``linear`` quantized as a conv is (per output row, the input per tensor),
its bias added in float32; LayerNorm, attention, GELU and sums in float32
on bfloat16 operands, their results kept in bfloat16.

``RoundedScoring``: the scoring path a configuration states as bfloat16
(TPU.COMPUTE_DTYPE bfloat16, no int8): every conv, transposed conv, linear
and attention product takes its input and weight rounded to bfloat16 and
sums in float32, its result kept in bfloat16; inference BatchNorm,
LayerNorm, softmax and GELU in float32 on the bfloat16 value, kept in
bfloat16; residual sums of bfloat16 values rounded to bfloat16; the final
1x1 conv in float32 on a float32 input.  ``fp8=True`` is its control, one
precision lower: the same with those operands rounded to float8 e4m3 (a
per-tensor scale to the format's largest) in place of bfloat16.
``scoring_arithmetic`` picks one from the configuration's
``precision.scoring``.

``TrainingArithmetic``: the training forward in train mode, BatchNorm with
the batch's statistics (mean and biased variance, recorded for the running
averages).  ``dtype`` float32 is the reference (every product in float32);
bfloat16 runs each conv on bfloat16 inputs and weights and keeps
activations in bfloat16 between layers, as a bf16-compute configuration
trains over float32 master weights; ``fp8=True`` is the control: every
conv's input and weight rounded to float8 e4m3 (a per-tensor scale to the
format's largest) in the forward, and the gradients that flow back into
them to float8 e5m2, as float8 training rounds them (the operands of
``linear`` and of attention's two products too).

All float32 work runs with TF32 off (the caller sets the flags).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BF16 = torch.bfloat16
BN_EPS = 1e-5
LN_EPS = 1e-6
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def fold_bn(gamma, beta, mean, var):
    scale = gamma / torch.sqrt(var + BN_EPS)
    return scale, beta - mean * scale


def normalize_bf16(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC crops -> normalized NCHW in bfloat16, as a bf16 scoring
    path normalizes them."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images_u8.device).to(BF16)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images_u8.device).to(BF16)
    x = (images_u8.to(BF16) / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2)


def normalize_f32(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC crops -> normalized NCHW float32 (the training input)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images_u8.device)
    x = (images_u8.to(torch.float32) / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def layer_norm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (mean and biased variance)."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * gamma.to(torch.float32) + beta.to(torch.float32)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[N, T, D] -> [N, heads, T, D / heads]."""
    n, length, d = t.shape
    return t.reshape(n, length, heads, d // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[N, heads, T, d] -> [N, T, heads * d]."""
    n, heads, length, d = t.shape
    return t.transpose(1, 2).reshape(n, length, heads * d)


def attention_scale(d: int, heads: int, scale: Optional[float]) -> float:
    return (d // heads) ** -0.5 if scale is None else float(scale)


class _Bf16Kept:
    """Primitives whose results are kept in bfloat16 and computed in float32
    from operands that ``_round`` rounds (to bfloat16 here)."""

    def _round(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(torch.float32).to(BF16).to(torch.float32)

    def add(self, a, b):
        return (a.to(BF16).to(torch.float32) + b.to(BF16).to(torch.float32)).to(BF16)

    def relu(self, x):
        return torch.relu(x)

    def maxpool(self, x):
        return F.max_pool2d(x, 3, 2, 1)

    def residual_relu(self, out, res):
        return torch.relu(out.to(torch.float32) + res.to(torch.float32)).to(BF16)

    def upsample(self, x, factor):
        return F.interpolate(x, scale_factor=factor, mode="nearest")

    def layer_norm(self, P, name, x, dim, eps: float = LN_EPS):
        gamma, beta = P.norm(name, dim)
        return layer_norm_f32(x, gamma, beta, eps).to(BF16)

    def gelu(self, x):
        return F.gelu(x.to(torch.float32)).to(BF16)

    def attention(self, q, k, v, heads: int, scale: Optional[float] = None):
        s = attention_scale(q.shape[-1], heads, scale)
        qh, kh, vh = (split_heads(self._round(t), heads) for t in (q, k, v))
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * s, dim=-1)
        return merge_heads(torch.matmul(self._round(p), vh)).to(BF16)


class QuantizedScoring(_Bf16Kept):
    """Inference with eval-mode BatchNorm, the trunk quantized to `qmax`
    levels a side.  `scales`: a table from a calibration pass (this class
    with ``scales=None`` records one in `recorded`)."""

    def __init__(self, qmax: int = 127, scales: Optional[Dict[str, torch.Tensor]] = None):
        self.qmax = float(qmax)
        self.scales = scales
        self.recorded: Dict[str, torch.Tensor] = {}

    def _input_scale(self, key: str, x: torch.Tensor) -> torch.Tensor:
        if self.scales is not None:
            return self.scales[key]
        sx = torch.clamp(torch.amax(torch.abs(x.to(torch.float32))), min=1e-8) / self.qmax
        self.recorded[key] = sx
        return sx

    def _q(self, v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(v / s), -self.qmax, self.qmax)

    def unit(self, P, conv, bn, x, cin, cout, k, stride, relu):
        w = P.conv(conv, cout, cin, k).to(torch.float32)
        gamma, beta, mean, var = P.bn(bn, cout)
        sx = self._input_scale(conv, x)
        ws = torch.clamp(torch.amax(torch.abs(w), dim=(1, 2, 3)), min=1e-8) / self.qmax
        xq = self._q(x.to(torch.float32), sx)
        wq = self._q(w, ws[:, None, None, None])
        # Integer operands and sums well inside float32's exact range: the
        # rounding restores the exact integer sum whatever the algorithm.
        acc = torch.round(F.conv2d(xq, wq, stride=stride, padding=k // 2))
        scale, bias = fold_bn(gamma, beta, mean, var)
        y = acc * (sx * ws * scale)[None, :, None, None] + bias[None, :, None, None]
        if relu:
            y = torch.relu(y)
        return y.to(BF16)

    def deconv_unit(self, P, conv, bn, x, cin, cout, k):
        w = P.get(conv + ".weight", (cin, cout, k, k), "conv").to(BF16)
        gamma, beta, mean, var = P.bn(bn, cout)
        y = F.conv_transpose2d(x.to(BF16), w, stride=2, padding=(k - 2) // 2)
        scale, bias = fold_bn(gamma, beta, mean, var)
        y = y.to(torch.float32) * scale[None, :, None, None] + bias[None, :, None, None]
        return torch.relu(y).to(BF16)

    def final(self, P, name, x, cin, cout, k):
        w = P.conv(name, cout, cin, k, kind="head").to(torch.float32)
        b = P.get(name + ".bias", (cout,), "bias").to(torch.float32)
        if k != 1:
            raise NotImplementedError("the quantized scoring head takes a 1x1 final conv")
        y = x.to(torch.float32).permute(0, 2, 3, 1) @ w[:, :, 0, 0].t() + b
        return y.permute(0, 3, 1, 2).contiguous()

    def linear(self, P, name, x, cin, cout, bias: bool = True, shape=None):
        w, b = P.linear(name, cout, cin, bias, shape)
        w = w.to(torch.float32)
        sx = self._input_scale(name, x)
        ws = torch.clamp(torch.amax(torch.abs(w), dim=1), min=1e-8) / self.qmax
        # Sums of up to 127^2 x `cin` products: float64 keeps them exact.
        xq = self._q(x.to(torch.float32), sx).to(torch.float64)
        wq = self._q(w, ws[:, None]).to(torch.float64)
        y = (xq @ wq.t()).to(torch.float32) * (sx * ws)
        if b is not None:
            y = y + b.to(torch.float32)
        return y.to(BF16)


class RoundedScoring(_Bf16Kept):
    """Inference with eval-mode BatchNorm in bfloat16 (see the module's
    docstring); with `fp8`, its control, the products' operands in float8
    e4m3."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _round(self, v: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _fp8(v.to(torch.float32), torch.float8_e4m3fn, 448.0)
        return super()._round(v)

    @staticmethod
    def _bn(y, gamma, beta, mean, var, relu: bool):
        def c(v):
            return v.to(torch.float32)[None, :, None, None]

        y = (y.to(torch.float32) - c(mean)) * torch.rsqrt(c(var) + BN_EPS) * c(gamma) + c(beta)
        return (torch.relu(y) if relu else y).to(BF16)

    def unit(self, P, conv, bn, x, cin, cout, k, stride, relu):
        w = P.conv(conv, cout, cin, k)
        gamma, beta, mean, var = P.bn(bn, cout)
        y = F.conv2d(self._round(x), self._round(w), stride=stride, padding=k // 2).to(BF16)
        return self._bn(y, gamma, beta, mean, var, relu)

    def deconv_unit(self, P, conv, bn, x, cin, cout, k):
        w = P.get(conv + ".weight", (cin, cout, k, k), "conv")
        gamma, beta, mean, var = P.bn(bn, cout)
        y = F.conv_transpose2d(self._round(x), self._round(w), stride=2,
                               padding=(k - 2) // 2).to(BF16)
        return self._bn(y, gamma, beta, mean, var, True)

    def final(self, P, name, x, cin, cout, k):
        w = P.conv(name, cout, cin, k, kind="head").to(torch.float32)
        b = P.get(name + ".bias", (cout,), "bias").to(torch.float32)
        return F.conv2d(x.to(torch.float32), w, b, padding=1 if k == 3 else 0)

    def linear(self, P, name, x, cin, cout, bias: bool = True, shape=None):
        w, b = P.linear(name, cout, cin, bias, shape)
        y = self._round(x) @ self._round(w).t()
        if b is not None:
            y = y + b.to(BF16).to(torch.float32)
        return y.to(BF16)


def scoring_arithmetic(precision: Dict, control: bool = False, scales=None):
    """The reference's scoring arithmetic for a configuration's
    ``precision`` block: ``scoring`` int8 is ``QuantizedScoring`` at its
    ``qmax`` (the control at 7, int4) with the scale table `scales`;
    bfloat16 is ``RoundedScoring`` (the control in float8 e4m3)."""
    scoring = precision["scoring"]
    if scoring == "int8":
        return QuantizedScoring(7 if control else int(precision["qmax"]), scales)
    if scoring == "bfloat16":
        return RoundedScoring(fp8=control)
    raise ValueError("no reference scoring arithmetic for precision %r" % scoring)


def _fp8(v: torch.Tensor, fmt, top: float) -> torch.Tensor:
    """`v` rounded to the float8 format `fmt` under a per-tensor scale that
    maps its largest magnitude to the format's largest value `top`."""
    f = v.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(f)), min=1e-30) / top
    return ((f / s).to(fmt).to(torch.float32) * s).to(v.dtype)


class _Fp8Round(torch.autograd.Function):
    """Float8 training's rounding: the value to e4m3 in the forward, its
    gradient to e5m2 in the backward."""

    @staticmethod
    def forward(ctx, v):
        return _fp8(v, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class TrainingArithmetic:
    """Train-mode forward over float32 master weights, its convs in `dtype`.
    `records` receives each BatchNorm's (mean, biased variance) in module
    order (the order of the state dict).  With `remat`, each conv unit
    (conv or transposed conv, BatchNorm, ReLU) is recomputed in the
    backward pass instead of keeping its activations."""

    def __init__(self, dtype=torch.float32, fp8: bool = False, remat: bool = False):
        self.dtype = dtype
        self.fp8 = fp8
        self.remat = remat
        self.records: List = []

    def _run(self, f, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(f, *args, use_reentrant=False)
        return f(*args)

    def _conv(self, x, w, stride, padding):
        x, w = self._operands(x, w)
        return F.conv2d(x, w, stride=stride, padding=padding)

    def _bn(self, x, gamma, beta):
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=(0, 2, 3))
        var = torch.mean(torch.square(xf - mean[None, :, None, None]), dim=(0, 2, 3))
        self.records.append((mean.detach(), var.detach()))
        y = (xf - mean[None, :, None, None]) * torch.rsqrt(var + BN_EPS)[None, :, None, None]
        return (y * gamma[None, :, None, None] + beta[None, :, None, None]).to(x.dtype)

    def unit(self, P, conv, bn, x, cin, cout, k, stride, relu):
        w = P.conv(conv, cout, cin, k)
        gamma, beta, _, _ = P.bn(bn, cout)

        def f(x, w, gamma, beta):
            y = self._bn(self._conv(x, w, stride, k // 2), gamma, beta)
            return torch.relu(y) if relu else y

        return self._run(f, x, w, gamma, beta)

    def maxpool(self, x):
        return F.max_pool2d(x, 3, 2, 1)

    def residual_relu(self, out, res):
        return torch.relu(out + res)

    def add(self, a, b):
        return a + b.to(a.dtype)

    def relu(self, x):
        return torch.relu(x)

    def upsample(self, x, factor):
        return F.interpolate(x, scale_factor=factor, mode="nearest")

    def _operands(self, *ts):
        ts = tuple(t.to(self.dtype) for t in ts)
        return tuple(_Fp8Round.apply(t) for t in ts) if self.fp8 else ts

    def linear(self, P, name, x, cin, cout, bias: bool = True, shape=None):
        w, b = P.linear(name, cout, cin, bias, shape)
        x, w = self._operands(x, w)
        return F.linear(x, w, None if b is None else b.to(self.dtype))

    def layer_norm(self, P, name, x, dim, eps: float = LN_EPS):
        gamma, beta = P.norm(name, dim)
        return layer_norm_f32(x, gamma, beta, eps).to(x.dtype)

    def gelu(self, x):
        return F.gelu(x)

    def attention(self, q, k, v, heads: int, scale: Optional[float] = None):
        s = attention_scale(q.shape[-1], heads, scale)
        qh, kh, vh = (split_heads(t, heads) for t in self._operands(q, k, v))
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)).to(torch.float32) * s, dim=-1)
        return merge_heads(torch.matmul(self._operands(p)[0], vh))

    def deconv_unit(self, P, conv, bn, x, cin, cout, k):
        w = P.get(conv + ".weight", (cin, cout, k, k), "conv")
        gamma, beta, _, _ = P.bn(bn, cout)

        def f(x, w, gamma, beta):
            x, w = self._operands(x, w)
            y = F.conv_transpose2d(x, w, stride=2, padding=(k - 2) // 2)
            return torch.relu(self._bn(y, gamma, beta))

        return self._run(f, x, w, gamma, beta)

    def final(self, P, name, x, cin, cout, k):
        w = P.conv(name, cout, cin, k, kind="head")
        b = P.get(name + ".bias", (cout,), "bias")
        return F.conv2d(x.to(torch.float32), w.to(torch.float32), b.to(torch.float32),
                        padding=1 if k == 3 else 0)
