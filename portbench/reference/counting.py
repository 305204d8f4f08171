"""Operations and bytes counted from shapes, for the roofline and
utilization metrics.

``forward_macs`` walks a configuration's topology (arch.py) on meta tensors
and counts each layer's multiply-adds from its shapes: a conv's
``k * k * Cin * Cout * Ho * Wo``, a transposed conv's ``k * k * Cin * Cout
* Hin * Win``, grouped by the kind of layer (trunk conv, head transposed
conv, final conv), so each kind can be held to the peak of the precision
the configuration runs it in.  Nothing is recounted for padding, nothing
for BatchNorm, ReLU or sums.  ``decode_bytes`` is K1's traffic: each
heatmap row read once (float32) and its packed row of 8 float32 written.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import arch


class MacCounter:
    """An arithmetic that only propagates shapes (meta tensors) and counts
    multiply-adds per crop by kind: ``conv``, ``deconv``, ``final``."""

    def __init__(self):
        self.macs: Dict[str, int] = {"conv": 0, "deconv": 0, "final": 0}

    def unit(self, P, conv, bn, x, cin, cout, k, stride, relu):
        w = P.conv(conv, cout, cin, k)
        P.bn(bn, cout)
        y = F.conv2d(x, w, stride=stride, padding=k // 2)
        self.macs["conv"] += k * k * cin * cout * y.shape[2] * y.shape[3]
        return y

    def maxpool(self, x):
        return F.max_pool2d(x, 3, 2, 1)

    def residual_relu(self, out, res):
        return out + res

    def add(self, a, b):
        return a + b

    def relu(self, x):
        return x

    def upsample(self, x, factor):
        return F.interpolate(x, scale_factor=factor, mode="nearest")

    def deconv_unit(self, P, conv, bn, x, cin, cout, k):
        w = P.get(conv + ".weight", (cin, cout, k, k), "conv")
        P.bn(bn, cout)
        self.macs["deconv"] += k * k * cin * cout * x.shape[2] * x.shape[3]
        return F.conv_transpose2d(x, w, stride=2, padding=(k - 2) // 2)

    def final(self, P, name, x, cin, cout, k):
        w = P.conv(name, cout, cin, k, kind="head")
        P.get(name + ".bias", (cout,), "bias")
        y = F.conv2d(x, w, padding=1 if k == 3 else 0)
        self.macs["final"] += k * k * cin * cout * y.shape[2] * y.shape[3]
        return y


def trace_model(model: Dict, image_size: int) -> Tuple[MacCounter, arch.Params]:
    """One crop through the topology on meta tensors: (counter, recorded
    parameters)."""
    counter, P = MacCounter(), arch.Params()
    x = torch.empty((1, 3, image_size, image_size), device="meta")
    arch.forward(model, P, counter, x)
    return counter, P


def forward_macs(model: Dict, image_size: int) -> Dict[str, int]:
    """Multiply-adds of one crop's forward, by kind of layer."""
    return dict(trace_model(model, image_size)[0].macs)


def min_seconds_per_crop(model: Dict, image_size: int, precision: Dict[str, str],
                         peaks: Dict[str, float], factor: float = 1.0) -> float:
    """The least time the chip could take on one crop's forward operations
    (2 per multiply-add), each kind of layer at the peak of the precision
    it runs in (`precision`: kind -> a key of `peaks`), times `factor` (3
    for a forward and backward)."""
    macs = forward_macs(model, image_size)
    return factor * sum(2.0 * n / peaks[precision[kind]] for kind, n in macs.items())


def decode_bytes(rows: int, row_len: int) -> int:
    """K1's bytes for `rows` float32 heatmap rows of `row_len` values: each
    read once, and the packed [rows, 8] float32 result written once."""
    return rows * row_len * 4 + rows * 8 * 4
