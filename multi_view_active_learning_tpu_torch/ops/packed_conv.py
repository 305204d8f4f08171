"""2x2-output-packed 3x3 convolution (the port of the JAX package's
ops/packed_conv.py).

A 3x3 stride-1 convolution with padding 1 over [N, C_in, H, W] (H and W
even) is computed as one 4x4 stride-2 convolution with 4 * C_out output
channels, each holding one fine output position (a, b) of a 2x2 output
tile, followed by a depth-to-space.  Fine output p = 2I + a reads fine
inputs 2I - 1 + (a + ky), so

    W4[(a * 2 + b) * C_out + co, ci, a + ky, b + kx] = K3[co, ci, ky, kx]

and zero elsewhere: the same products for every output, at 16/9 times the
multiply-adds.  The JAX package chose it for the TPU's 128-lane matrix
unit, which a 32-channel output fills a quarter of; what it buys on an
H100's cuDNN is measured, not assumed (``chip_smoke.py``'s
``phase_reformulations``).  The packed kernel is built from the unchanged
[C_out, C_in, 3, 3] weight at every call, so state dicts and the converter
see the standard layer's parameter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_kernel_2x2(kernel: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, 3, 3] -> [4 * C_out, C_in, 4, 4]: output channel block
    (a * 2 + b) holds the fine output position (row a, column b) of each
    2x2 output tile (JAX's [4, 4, C_in, 4 * C_out], transposed)."""
    c_out, c_in, kh, kw = kernel.shape
    if (kh, kw) != (3, 3):
        raise ValueError("pack_kernel_2x2 takes a 3x3 kernel, got %s" % (tuple(kernel.shape),))
    w4 = kernel.new_zeros((4, c_out, c_in, 4, 4))
    for a in (0, 1):
        for b in (0, 1):
            w4[a * 2 + b, :, :, a:a + 3, b:b + 3] = kernel
    return w4.reshape(4 * c_out, c_in, 4, 4)


def packed_conv3x3(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 padding-1 conv [N, C_in, H, W] -> [N, C_out, H, W]
    computed 2x2-output-packed (see the module docstring); H and W must be
    even.  Runs in x's dtype."""
    n, _, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError("packed_conv3x3 needs even spatial dims, got %dx%d" % (h, w))
    c_out = kernel.shape[0]
    y = F.conv2d(x, pack_kernel_2x2(kernel.to(x.dtype)), stride=2, padding=1)
    # depth-to-space: [N, (a, b, co), H/2, W/2] -> [N, co, H/2, a, W/2, b].
    y = y.reshape(n, 2, 2, c_out, h // 2, w // 2).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c_out, h, w)
