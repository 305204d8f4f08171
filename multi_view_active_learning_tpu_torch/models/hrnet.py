"""HRNet pose estimator (HRNet-W32 by default), NCHW.

Topology of the reference (pose_estimators/hrnet.py:98-533) and of the JAX
package's models/hrnet.py, with the reference's torch module names, so a
reference state_dict (and ``convert.from_flax(..., "HRNET")``'s output)
loads with ``strict=True``:

  stem: conv1 / bn1, conv2 / bn2 (two stride-2 3x3 convs) -> layer1 (four
  Bottleneck-64) -> three stages of parallel multi-resolution branches
  (``transition{t}``, ``stage{s}.{m}.branches``), fused by summing exchange
  units (``stage{s}.{m}.fuse_layers``: 1x1 conv + BN + nearest upsample from
  a lower resolution, chains of stride-2 3x3 convs from a higher one) ->
  the last module keeps the high-resolution branch -> ``final_layer``.
  Input 256x256 -> heatmaps 64x64 (stride 4).

Dtype policy of the JAX package (models/hrnet.py): the convolutions, the
exchange sums and the ReLUs run in the compute dtype, batch norm keeps
float32 parameters and statistics (as the port's PoseResNet), and the final
conv runs in float32 on the float32 high-resolution branch, so heatmaps are
float32.  Training follows the JAX package as PoseResNet does
(models/layers.py); ``remat`` (TPU.REMAT) rematerializes each layer1 block
and each stage module in the backward pass.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, run_block
from .pose_resnet import BN_MOMENTUM, BasicBlock, Bottleneck

BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, relu: bool) -> nn.Sequential:
    layers = [Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False),
              BatchNorm2d(cout, momentum=BN_MOMENTUM)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


def _branch(block, inplanes: int, planes: int, blocks: int,
            packed: bool = False) -> nn.Sequential:
    """One branch's residual blocks; the first projects when widths differ.
    `packed`: BasicBlocks with 2x2-output-packed 3x3 convs."""
    downsample = None
    if inplanes != planes * block.expansion:
        downsample = nn.Sequential(
            Conv2d(inplanes, planes * block.expansion, 1, 1, bias=False),
            BatchNorm2d(planes * block.expansion, momentum=BN_MOMENTUM),
        )
    layers = [block(inplanes, planes, 1, downsample, packed=packed)]
    layers += [block(planes * block.expansion, planes, packed=packed) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class HighResolutionModule(nn.Module):
    """Parallel branches and the summing exchange unit (reference:
    hrnet.py:98-287).  ``fuse_layers[i][j]`` carries branch j to branch i's
    resolution and width: None for j == i, 1x1 conv + BN + nearest upsample
    for j > i, a chain of stride-2 3x3 conv + BN for j < i with a ReLU on
    every step but the last.  Branches of BasicBlocks with at most
    `packed_max_channels` channels pack their 3x3 convs (JAX
    models/hrnet.py:64-90; 0: none)."""

    def __init__(self, num_branches: int, block: str, num_blocks: Sequence[int],
                 num_inchannels: Sequence[int], num_channels: Sequence[int],
                 multi_scale_output: bool = True, packed_max_channels: int = 0):
        super().__init__()
        block_cls = BLOCKS[block]
        out = [c * block_cls.expansion for c in num_channels]
        self.num_branches = num_branches
        self.branches = nn.ModuleList(
            _branch(block_cls, num_inchannels[b], num_channels[b], num_blocks[b],
                    packed=block == "BASIC" and out[b] <= packed_max_channels)
            for b in range(num_branches))
        self.fuse_layers = None
        if num_branches > 1:
            fuse = []
            for i in range(num_branches if multi_scale_output else 1):
                row: List = []
                for j in range(num_branches):
                    if j > i:
                        row.append(nn.Sequential(
                            Conv2d(out[j], out[i], 1, 1, 0, bias=False),
                            BatchNorm2d(out[i], momentum=BN_MOMENTUM),
                            nn.Upsample(scale_factor=2 ** (j - i), mode="nearest")))
                    elif j == i:
                        row.append(None)
                    else:
                        row.append(nn.Sequential(*(
                            _conv_bn(out[j], out[i] if k == i - j - 1 else out[j], 3, 2,
                                     relu=k != i - j - 1)
                            for k in range(i - j))))
                fuse.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(fuse)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = ys[j] if j == i else layer(ys[j])
                acc = y if acc is None else acc + y
            fused.append(self.relu(acc))
        return fused


def _stage_tuple(s):
    return (s.NUM_MODULES, s.NUM_BRANCHES, s.BLOCK, tuple(s.NUM_BLOCKS), tuple(s.NUM_CHANNELS))


class PoseHighResolutionNet(nn.Module):
    """images [N, 3, H, W] -> heatmaps [N, num_joints, H/4, W/4] float32
    (reference: hrnet.py:293-501).  Stages are (num_modules, num_branches,
    block, num_blocks, num_channels), the JAX package's encoding.
    `packed_max_channels`: TPU.HRNET_PACKED_MAX_CH (HighResolutionModule)."""

    def __init__(self, num_joints: int,
                 stage2=(1, 2, "BASIC", (4, 4), (32, 64)),
                 stage3=(4, 3, "BASIC", (4, 4, 4), (32, 64, 128)),
                 stage4=(3, 4, "BASIC", (4, 4, 4, 4), (32, 64, 128, 256)),
                 final_conv_kernel: int = 1, dtype: torch.dtype = torch.float32,
                 packed_max_channels: int = 0):
        super().__init__()
        self.compute_dtype = dtype
        self.remat = False
        self.stage_configs = (stage2, stage3, stage4)
        self.final_conv_kernel = final_conv_kernel
        self.conv1 = Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64, momentum=BN_MOMENTUM)
        self.conv2 = Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64, momentum=BN_MOMENTUM)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = _branch(Bottleneck, 64, 64, 4)
        prev = [256]
        for s, cfg in ((2, stage2), (3, stage3), (4, stage4)):
            num_modules, num_branches, block, num_blocks, num_channels = cfg
            cur = [c * BLOCKS[block].expansion for c in num_channels]
            transition: List = []
            for i in range(num_branches):
                if i < len(prev):
                    transition.append(_conv_bn(prev[i], cur[i], 3, 1, True)
                                      if cur[i] != prev[i] else None)
                else:
                    transition.append(nn.Sequential(*(
                        _conv_bn(prev[-1], cur[i] if j == i - len(prev) else prev[-1], 3, 2, True)
                        for j in range(i + 1 - len(prev)))))
            setattr(self, "transition%d" % (s - 1), nn.ModuleList(transition))
            setattr(self, "stage%d" % s, nn.Sequential(*(
                HighResolutionModule(num_branches, block, num_blocks, cur, num_channels,
                                     multi_scale_output=not (s == 4 and m == num_modules - 1),
                                     packed_max_channels=packed_max_channels)
                for m in range(num_modules))))
            prev = cur
        self.final_layer = Conv2d(prev[0], num_joints, final_conv_kernel, 1,
                                     1 if final_conv_kernel == 3 else 0)
        # Compute-dtype weights for every conv but the float32 final layer.
        for module in self.modules():
            if isinstance(module, Conv2d) and module is not self.final_layer:
                module.to(dtype)

    @classmethod
    def from_config(cls, num_joints: int, hrnet_cfg, dtype: torch.dtype = torch.float32,
                    packed_max_channels: int = 0):
        """From ``POSE_ESTIMATOR.HRNET`` of the config."""
        return cls(num_joints, _stage_tuple(hrnet_cfg.STAGE2), _stage_tuple(hrnet_cfg.STAGE3),
                   _stage_tuple(hrnet_cfg.STAGE4), hrnet_cfg.FINAL_CONV_KERNEL, dtype,
                   packed_max_channels)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """return_features=True returns (heatmaps, pooled), with pooled the
        float32 spatial mean of the high-resolution branch [N, C]: the
        AL.CORESET_FEATURES=EMBEDDING feature space."""
        x = x.to(self.compute_dtype)
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        for block in self.layer1:
            x = run_block(block, x, self.remat)
        ys = [x]
        for s in (2, 3, 4):
            xs = []
            for i, t in enumerate(getattr(self, "transition%d" % (s - 1))):
                if i < len(ys):
                    xs.append(ys[i] if t is None else t(ys[i]))
                else:
                    xs.append(t(ys[-1]))
            for module in getattr(self, "stage%d" % s):
                xs = run_block(module, xs, self.remat)
            ys = xs
        high = ys[0].to(torch.float32)
        out = self.final_layer(high)
        if return_features:
            return out, torch.mean(high, dim=(2, 3))
        return out
