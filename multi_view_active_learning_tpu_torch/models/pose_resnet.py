"""PoseResNet (Simple Baselines for Human Pose Estimation), NCHW.

Topology of the reference (pose_estimators/pose_resnet.py:17-231) with its
torch module names, so a reference state_dict (and ``convert.from_flax``'s
output) loads with ``strict=True``:
ResNet-{18,34,50,101,152} trunk -> 3x (ConvTranspose2d 256, k4, s2, p1) +
BN + ReLU -> 1x1 conv to num_joints heatmaps; stride 4 overall.

Dtype policy of the JAX package (models/pose_resnet.py:305, 354-360): the
convolutions run in the compute dtype (float32 or bfloat16; the inference
model stores their weights in it, training binds float32 master weights,
models/layers.py), batch norm keeps float32 parameters and statistics and
normalizes in float32 (its output is cast back to the compute dtype), and
the final 1x1 conv runs in float32 on a float32 input -- so heatmaps are
always float32.  In train mode batch norm follows flax (layers.py), and
``remat`` (TPU.REMAT) rematerializes every residual block and the head in
the backward pass.

The JAX package's exact reformulations (models/pose_resnet.py there) keep
the standard layers' parameters and names and compute the same function:
``SpaceToDepthStem`` (always the stem: with a space-to-depth'd 12-channel
input, TPU.SPACE_TO_DEPTH_STEM, it runs as a dense 4x4 stride-1 conv),
``PhaseDeconv`` (TPU.FAST_DECONV: each k4/s2 transposed conv as one dense
2x2 conv and a phase interleave) and ``PackedConv2d`` (a BasicBlock's
stride-1 3x3 convs 2x2-output-packed, ops/packed_conv.py; HRNet's
TPU.HRNET_PACKED_MAX_CH).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import space_to_depth  # noqa: F401  (the stem's input; JAX keeps it here)
from ..ops.packed_conv import packed_conv3x3
from .layers import BatchNorm2d, Conv2d, ConvTranspose2d, run_block

BN_MOMENTUM = 0.1


class SpaceToDepthStem(Conv2d):
    """The 7x7 stride-2 stem conv, on plain [N, C, H, W] input or on
    space-to-depth'd [N, 4C, H/2, W/2] input.

    Plain input runs the standard conv.  For the other, with
    ``x_s2d[m, p] = x[2m + p]`` and ``k = 2t + p - 1``, ``y[o] = sum_k w[k]
    x[2o + k - 3] = sum_{t, p} w[2t + p - 1] x_s2d[o + t - 2, p]``: a 4x4
    stride-1 conv with padding (2, 1) whose weight is the stem's padded by
    one tap at the top and left and regrouped, ``w_s2d[co, (p, q, c), t, u]
    = wp[co, c, 2t + p, 2u + q]`` (JAX's SpaceToDepthStem)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.in_channels
        if x.shape[1] == c:
            return super().forward(x)
        if x.shape[1] != 4 * c:
            raise ValueError("stem expects %d or %d channels, got %d" % (c, 4 * c, x.shape[1]))
        co = self.out_channels
        wp = F.pad(self.weight.to(x.dtype), (1, 0, 1, 0))  # [co, c, 8, 8]
        ws = wp.reshape(co, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(co, 4 * c, 4, 4)
        return F.conv2d(F.pad(x, (2, 1, 2, 1)), ws)


class PackedConv2d(Conv2d):
    """A 3x3 stride-1 padding-1 conv computed 2x2-output-packed
    (ops/packed_conv.py) where H and W are even, else as the standard conv
    (JAX's odd-size fallback); the same parameter either way."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] % 2 or x.shape[-1] % 2:
            return super().forward(x)
        return packed_conv3x3(x, self.weight)


class PhaseDeconv(ConvTranspose2d):
    """ConvTranspose2d(k4, s2, p1) as one dense 2x2 conv (padding 1) over
    4 * C_out phase kernels and a phase interleave (JAX's PhaseDeconv).

    Output row 2m + r reads input rows m - 1 + r and m + r through taps
    3 - r and 1 - r: phase r's kernel is ``k2[a] = W[3 - 2a - r]``, and its
    plane is the 2x2 conv's output shifted by r.  The weight keeps
    ConvTranspose2d's [C_in, C_out, 4, 4] layout and name."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        cin, cout = self.weight.shape[:2]
        # k2[(r, s, co), ci, a, b] = W[ci, co, 3 - 2a - r, 3 - 2b - s].
        wf = self.weight.to(x.dtype).flip(2, 3).reshape(cin, cout, 2, 2, 2, 2)
        k2 = wf.permute(3, 5, 1, 0, 2, 4).reshape(4 * cout, cin, 2, 2)
        z = F.conv2d(x, k2, padding=1).reshape(n, 2, 2, cout, h + 1, w + 1)
        rows = [torch.stack([z[:, r, s, :, r:r + h, s:s + w] for s in (0, 1)], dim=-1)
                for r in (0, 1)]  # [n, co, h, w, 2(s)] each
        y = torch.stack(rows, dim=3).reshape(n, cout, 2 * h, 2 * w)
        return y if self.bias is None else y + self.bias.to(x.dtype)[:, None, None]


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (reference: pose_resnet.py:156-189).
    `packed` computes its stride-1 3x3 convs 2x2-output-packed."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, packed: bool = False):
        super().__init__()
        conv1 = PackedConv2d if packed and stride == 1 else Conv2d
        conv2 = PackedConv2d if packed else Conv2d
        self.conv1 = conv1(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv2 = conv2(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4) residual block
    (reference: pose_resnet.py:192-231)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, packed: bool = False):
        # `packed` is taken for uniformity with BasicBlock and ignored, as in
        # JAX: the bottleneck's 3x3 runs at 64 channels or more.
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv3 = Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * self.expansion, momentum=BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class PoseResNet(nn.Module):
    """images [N, 3, H, W] (or space-to-depth'd [N, 12, H/2, W/2]) ->
    heatmaps [N, num_joints, H/4, W/4] float32.  `fast_deconv` builds the
    head's transposed convs as PhaseDeconv."""

    def __init__(self, num_joints: int, num_layers: int = 50,
                 dtype: torch.dtype = torch.float32, fast_deconv: bool = False):
        super().__init__()
        if num_layers not in RESNET_SPEC:
            raise ValueError("PoseResNet depth must be one of %s" % sorted(RESNET_SPEC))
        block, layer_sizes = RESNET_SPEC[num_layers]
        self.compute_dtype = dtype
        self.remat = False
        self.conv1 = SpaceToDepthStem(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, momentum=BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layer_sizes)):
            stride = 1 if stage == 0 else 2
            layers = []
            for i in range(blocks):
                downsample = None
                if i == 0 and (stride != 1 or inplanes != planes * block.expansion):
                    downsample = nn.Sequential(
                        Conv2d(inplanes, planes * block.expansion, 1, stride, bias=False),
                        BatchNorm2d(planes * block.expansion, momentum=BN_MOMENTUM),
                    )
                layers.append(block(inplanes, planes, stride if i == 0 else 1, downsample))
                inplanes = planes * block.expansion
            setattr(self, "layer%d" % (stage + 1), nn.Sequential(*layers))
        head = []
        deconv = PhaseDeconv if fast_deconv else ConvTranspose2d
        for _ in range(3):
            head += [
                deconv(inplanes, 256, 4, 2, 1, output_padding=0, bias=False),
                BatchNorm2d(256, momentum=BN_MOMENTUM),
                nn.ReLU(inplace=True),
            ]
            inplanes = 256
        self.deconv_layers = nn.Sequential(*head)
        self.final_layer = Conv2d(256, num_joints, 1)
        # Compute-dtype weights for every conv but the float32 final layer.
        for module in self.modules():
            if isinstance(module, (Conv2d, ConvTranspose2d)) and module is not self.final_layer:
                module.to(dtype)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = run_block(block, x, self.remat)
        return x

    def forward(self, x: torch.Tensor, skip_head: bool = False,
                return_features: bool = False):
        """skip_head=True returns the trunk output [N, C, H/32, W/32].
        return_features=True returns (heatmaps, pooled), with pooled the
        float32 global average of the trunk output [N, C]."""
        x = self.trunk(x)
        if skip_head:
            return x
        pooled = torch.mean(x.to(torch.float32), dim=(2, 3)) if return_features else None
        x = run_block(self.deconv_layers, x, self.remat)
        x = self.final_layer(x.to(torch.float32))
        if return_features:
            return x, pooled
        return x
