"""The kernels K1, K3, K4 and K5 as registered PyTorch operators (``torch.ops.mval``).

Each is a ``torch.library.custom_op`` whose operands are plain tensors and
scalars, with three implementations:

  * a CPU kernel, the kernel's plain version;
  * a CUDA kernel, which builds the launch plan from the real tensor (its
    address, strides and the card's SMs), launches through ``_build``,
    counts the launch on its wrapper (``decode.fused_decode.launches``,
    ``deconv.fused_deconv_bn_relu.launches``,
    ``deconv.fused_deconv_bn_relu_int8.launches``,
    ``int8_conv.int8_conv_bn.launches``), or raises;
  * a fake implementation, the result's shape and dtype for symbolic
    shapes, which ``torch.export`` and FakeTensor tracing run instead.

The wrappers (``decode.fused_decode``, ``deconv.fused_deconv_bn_relu_packed``,
``deconv.fused_deconv_bn_relu_int8_packed``, ``int8_conv.int8_conv_bn``) check their operands and call
these operators, so eager code and an exported graph take one route.  An
exported program that calls them (``serving.py``'s ``.pt2`` artifacts)
needs this module imported before it loads: importing
``multi_view_active_learning_tpu_torch.kernels`` registers them, and builds
nothing.  K2 (``pairwise.min_distance_to_centers``) is on no exported path
and is not registered.
"""

from typing import Optional

import torch

from . import deconv, decode, int8_conv


@torch.library.custom_op("mval::fused_decode", mutates_args=(), device_types="cpu")
def fused_decode(heatmaps: torch.Tensor, width: int, stride: float) -> torch.Tensor:
    """[M, h*w] float32 rows -> packed [M, 8] (x, y, peak, soft_x, soft_y,
    0, 0, 0), the plain version on the CPU."""
    return decode.fused_decode_plain(heatmaps, width, stride)


@fused_decode.register_kernel("cuda")
def _fused_decode_cuda(heatmaps, width, stride):
    out = decode.launch(heatmaps, width, stride)
    decode.fused_decode.launches += 1
    return out


@fused_decode.register_fake
def _fused_decode_fake(heatmaps, width, stride):
    return heatmaps.new_empty((heatmaps.shape[0], decode.OUT_COLS), dtype=torch.float32)


@torch.library.custom_op("mval::fused_deconv_bn_relu", mutates_args=(), device_types="cpu")
def fused_deconv_bn_relu(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, wpk: torch.Tensor) -> torch.Tensor:
    """K3 on ``deconv.K3Operands``' tensors: x [N, H, W, Cin] -> [N, 2H, 2W,
    Cout] in x's type; the plain version (raw ``weight``) on the CPU."""
    return deconv.fused_deconv_bn_relu_plain(x, weight, scale, bias)


@fused_deconv_bn_relu.register_kernel("cuda")
def _fused_deconv_bn_relu_cuda(x, weight, scale, bias, wpk):
    deconv._check_cuda(x, wpk.shape[1], "fused_deconv_bn_relu", weight, scale, bias, wpk)
    out = deconv.launch(x, deconv.K3Operands(weight, scale, bias, wpk))
    deconv.fused_deconv_bn_relu.launches += 1
    return out


@fused_deconv_bn_relu.register_fake
def _fused_deconv_bn_relu_fake(x, weight, scale, bias, wpk):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, wpk.shape[1]))


@torch.library.custom_op("mval::fused_deconv_bn_relu_int8", mutates_args=(), device_types="cpu")
def fused_deconv_bn_relu_int8(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor, wpk: torch.Tensor,
                              act_scale: torch.Tensor) -> torch.Tensor:
    """K4 on ``deconv.K4Operands``' tensors and the activation scale (a
    float32 scalar tensor); the plain version (raw ``wq``) on the CPU."""
    return deconv.fused_deconv_bn_relu_int8_plain(x, wq, ws, scale, bias, act_scale)


@fused_deconv_bn_relu_int8.register_kernel("cuda")
def _fused_deconv_bn_relu_int8_cuda(x, wq, ws, scale, bias, wpk, act_scale):
    deconv._check_cuda(x, wpk.shape[1], "fused_deconv_bn_relu_int8", wq, ws, scale, bias, wpk,
                       act_scale)
    out = deconv.launch(x, deconv.K4Operands(wq, ws, scale, bias, wpk), act_scale)
    deconv.fused_deconv_bn_relu_int8.launches += 1
    return out


@fused_deconv_bn_relu_int8.register_fake
def _fused_deconv_bn_relu_int8_fake(x, wq, ws, scale, bias, wpk, act_scale):
    n, h, w, _ = x.shape
    return x.new_empty((n, 2 * h, 2 * w, wpk.shape[1]))



@torch.library.custom_op("mval::int8_conv_bn", mutates_args=(), device_types="cpu")
def int8_conv_bn(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, act_scale: torch.Tensor, residual: Optional[torch.Tensor],
                 stride: int, pad_before: int, pad_after: int, relu: bool) -> torch.Tensor:
    """K5, the int8 conv unit: x [N, H, W, Cin] -> bf16 [N, Ho, Wo, Cout];
    the plain twin on the CPU."""
    return int8_conv.int8_conv_bn_plain(x, wq, ws, scale, bias, act_scale, residual, stride,
                                        (pad_before, pad_after), relu)


@int8_conv_bn.register_kernel("cuda")
def _int8_conv_bn_cuda(x, wq, ws, scale, bias, act_scale, residual, stride, pad_before, pad_after,
                       relu):
    out = int8_conv.launch(x, wq, ws, scale, bias, act_scale, residual, stride,
                           (pad_before, pad_after), relu)
    int8_conv.int8_conv_bn.launches += 1
    return out


@int8_conv_bn.register_fake
def _int8_conv_bn_fake(x, wq, ws, scale, bias, act_scale, residual, stride, pad_before, pad_after,
                       relu):
    k = wq.shape[1]
    ho = (x.shape[1] + pad_before + pad_after - k) // stride + 1
    wo = (x.shape[2] + pad_before + pad_after - k) // stride + 1
    return x.new_empty((x.shape[0], ho, wo, wq.shape[0]), dtype=torch.bfloat16)
