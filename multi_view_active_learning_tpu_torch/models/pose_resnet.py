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
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, ConvTranspose2d, run_block

BN_MOMENTUM = 0.1


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (reference: pose_resnet.py:156-189)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, momentum=BN_MOMENTUM)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
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
                 downsample: Optional[nn.Module] = None):
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
    """images [N, 3, H, W] -> heatmaps [N, num_joints, H/4, W/4] float32."""

    def __init__(self, num_joints: int, num_layers: int = 50,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_layers not in RESNET_SPEC:
            raise ValueError("PoseResNet depth must be one of %s" % sorted(RESNET_SPEC))
        block, layer_sizes = RESNET_SPEC[num_layers]
        self.compute_dtype = dtype
        self.remat = False
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
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
        for _ in range(3):
            head += [
                ConvTranspose2d(inplanes, 256, 4, 2, 1, output_padding=0, bias=False),
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
