"""Plain PyTorch forwards of the benchmark's architectures.

PoseResNet (Xiao et al., "Simple Baselines for Human Pose Estimation and
Tracking", ECCV 2018): a ResNet trunk, three 4x4 stride-2 transposed convs
of 256 filters with BN and ReLU, and a 1x1 conv to the joints' heatmaps.
HRNet (Sun et al., "Deep High-Resolution Representation Learning for Human
Pose Estimation", CVPR, 2019): a two-conv stem, four bottlenecks, three
stages of parallel branches of basic blocks joined by summing exchange
units, and a 1x1 conv on the high-resolution branch.

Each topology is written once, as a function of a parameter source ``P``
and an arithmetic ``ops``.  ``P`` either hands out the tensors of a state
dict (under the reference repo's module names, the names the port loads)
or, given meta tensors, records every parameter's name, shape and kind:
that record is what the benchmark's seeded weights are drawn from.  The
arithmetics live in ``precision.py`` and ``counting.py``.  Nothing here
imports the program.

The two convolutional topologies are kept here (``ARCHS``); any other
``model["arch"]`` is the function ``forward(P, ops, x, model)`` of
``reference/arch_<arch>.py``, found by that name.  Besides the conv
primitives (``unit``, ``deconv_unit``, ``final``, ``maxpool``,
``residual_relu``, ``add``, ``relu``, ``upsample``) every arithmetic has
those of a transformer block: ``linear`` (a weight [out, in], or of the
given `shape` flattened to that, and a bias), ``layer_norm``,
``attention`` (softmax(q k^T * scale) v over heads, q, k, v [N, T, D]),
``gelu`` (erf); a learned table (a position embedding) is a parameter of
kind ``table``, fetched with ``P.get`` and summed with ``add``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import torch

BN_PARAMS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


class Params:
    """Parameters by name: from `tensors`, or, with ``tensors=None``, made
    on the meta device and recorded in `spec` as (name, shape, kind)."""

    def __init__(self, tensors: Optional[Dict[str, torch.Tensor]] = None):
        self.tensors = tensors
        self.spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def get(self, name: str, shape, kind: str) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.tensors is None:
            self.spec.append((name, shape, kind))
            dtype = torch.int64 if kind == "count" else torch.float32
            return torch.empty(shape, dtype=dtype, device="meta")
        t = self.tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError("%s: expected shape %s, got %s" % (name, shape, tuple(t.shape)))
        return t

    def conv(self, name: str, cout: int, cin: int, k: int, kind: str = "conv") -> torch.Tensor:
        return self.get(name + ".weight", (cout, cin, k, k), kind)

    def bn(self, name: str, c: int):
        out = tuple(self.get("%s.%s" % (name, leaf), (c,), leaf) for leaf in BN_PARAMS[:4])
        self.get(name + ".num_batches_tracked", (), "count")
        return out

    def linear(self, name: str, cout: int, cin: int, bias: bool = True, shape=None):
        """(weight [cout, cin], bias [cout] or None); a weight stored in
        another `shape` (a patch embedding's [D, C, p, p]) is flattened."""
        w = self.get(name + ".weight", shape or (cout, cin), "linear").reshape(cout, cin)
        return w, (self.get(name + ".bias", (cout,), "bias") if bias else None)

    def norm(self, name: str, c: int):
        """A LayerNorm's (weight, bias), each [c]."""
        return self.get(name + ".weight", (c,), "weight"), self.get(name + ".bias", (c,), "bias")


# --------------------------------------------------------------- PoseResNet

RESNET_BLOCKS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
                 50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
                 152: ("bottleneck", (3, 8, 36, 3))}


def _basic(P, ops, name, x, cin, planes, stride, downsample):
    out = ops.unit(P, name + ".conv1", name + ".bn1", x, cin, planes, 3, stride, True)
    out = ops.unit(P, name + ".conv2", name + ".bn2", out, planes, planes, 3, 1, False)
    res = x
    if downsample:
        res = ops.unit(P, name + ".downsample.0", name + ".downsample.1", x, cin, planes, 1,
                       stride, False)
    return ops.residual_relu(out, res)


def _bottleneck(P, ops, name, x, cin, planes, stride, downsample):
    out = ops.unit(P, name + ".conv1", name + ".bn1", x, cin, planes, 1, 1, True)
    out = ops.unit(P, name + ".conv2", name + ".bn2", out, planes, planes, 3, stride, True)
    out = ops.unit(P, name + ".conv3", name + ".bn3", out, planes, 4 * planes, 1, 1, False)
    res = x
    if downsample:
        res = ops.unit(P, name + ".downsample.0", name + ".downsample.1", x, cin, 4 * planes, 1,
                       stride, False)
    return ops.residual_relu(out, res)


def pose_resnet(P: Params, ops, x: torch.Tensor, model: Dict) -> torch.Tensor:
    """x: the normalized crops [N, 3, H, W] in the arithmetic's dtype ->
    heatmaps [N, K, H/4, W/4] float32."""
    kind, sizes = RESNET_BLOCKS[int(model["num_layers"])]
    block, expansion = (_basic, 1) if kind == "basic" else (_bottleneck, 4)
    x = ops.unit(P, "conv1", "bn1", x, 3, 64, 7, 2, True)
    x = ops.maxpool(x)
    cin = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), sizes)):
        stride = 1 if stage == 0 else 2
        for i in range(blocks):
            down = i == 0 and (stride != 1 or cin != planes * expansion)
            x = block(P, ops, "layer%d.%d" % (stage + 1, i), x, cin, planes,
                      stride if i == 0 else 1, down)
            cin = planes * expansion
    filters, kernel = int(model["num_deconv_filters"]), int(model["num_deconv_kernel"])
    for i in range(int(model["num_deconv_layers"])):
        x = ops.deconv_unit(P, "deconv_layers.%d" % (3 * i), "deconv_layers.%d" % (3 * i + 1), x,
                            cin, filters, kernel)
        cin = filters
    return ops.final(P, "final_layer", x, cin, int(model["num_joints"]),
                     int(model["final_conv_kernel"]))


# -------------------------------------------------------------------- HRNet


def _branch(P, ops, name, x, cin, c, blocks):
    for b in range(blocks):
        x = _basic(P, ops, "%s.%d" % (name, b), x, cin if b == 0 else c, c, 1,
                   b == 0 and cin != c)
    return x


def _exchange(P, ops, name, ys, channels, multi_scale_output):
    n = len(ys)
    out = []
    for i in range(n if multi_scale_output else 1):
        acc = None
        for j in range(n):
            base = "%s.fuse_layers.%d.%d" % (name, i, j)
            if j == i:
                y = ys[j]
            elif j > i:
                y = ops.unit(P, base + ".0", base + ".1", ys[j], channels[j], channels[i], 1, 1,
                             False)
                y = ops.upsample(y, 2 ** (j - i))
            else:
                y = ys[j]
                for k in range(i - j):
                    last = k == i - j - 1
                    y = ops.unit(P, "%s.%d.0" % (base, k), "%s.%d.1" % (base, k), y, channels[j],
                                 channels[i] if last else channels[j], 3, 2, not last)
            acc = y if acc is None else ops.add(acc, y)
        out.append(ops.relu(acc))
    return out


def hrnet(P: Params, ops, x: torch.Tensor, model: Dict) -> torch.Tensor:
    """x: the normalized crops [N, 3, H, W] -> heatmaps [N, K, H/4, W/4]
    float32.  ``model["stages"]``: [num_modules, num_blocks, channels] of
    stages 2-4, basic blocks, summing exchange."""
    x = ops.unit(P, "conv1", "bn1", x, 3, 64, 3, 2, True)
    x = ops.unit(P, "conv2", "bn2", x, 64, 64, 3, 2, True)
    cin = 64
    for b in range(4):
        x = _bottleneck(P, ops, "layer1.%d" % b, x, cin, 64, 1, b == 0)
        cin = 256
    ys, prev = [x], [256]
    for s, (modules, blocks, channels) in enumerate(model["stages"], start=2):
        xs = []
        for i, c in enumerate(channels):
            name = "transition%d.%d" % (s - 1, i)
            if i < len(prev):
                xs.append(ys[i] if c == prev[i] else
                          ops.unit(P, name + ".0", name + ".1", ys[i], prev[i], c, 3, 1, True))
            else:
                y = ys[-1]
                for j in range(i + 1 - len(prev)):
                    last = j == i - len(prev)
                    y = ops.unit(P, "%s.%d.0" % (name, j), "%s.%d.1" % (name, j), y, prev[-1],
                                 c if last else prev[-1], 3, 2, True)
                xs.append(y)
        for m in range(modules):
            name = "stage%d.%d" % (s, m)
            xs = [_branch(P, ops, "%s.branches.%d" % (name, i), xx, c, c, blocks)
                  for i, (xx, c) in enumerate(zip(xs, channels))]
            multi = not (s == 4 and m == modules - 1)
            xs = _exchange(P, ops, name, xs, channels, multi)
        ys, prev = xs, list(channels)
    return ops.final(P, "final_layer", ys[0], prev[0], int(model["num_joints"]),
                     int(model["final_conv_kernel"]))


ARCHS = {"pose_resnet": pose_resnet, "hrnet": hrnet}


def topology(name: str):
    """The forward of architecture `name`: one of ``ARCHS``, else
    ``forward`` of ``reference/arch_<name>.py``."""
    if name in ARCHS:
        return ARCHS[name]
    return importlib.import_module("%s.arch_%s" % (__package__, name)).forward


def forward(model: Dict, P: Params, ops, x: torch.Tensor) -> torch.Tensor:
    return topology(model["arch"])(P, ops, x, model)
