"""Operations and bytes counted from shapes, for the roofline and
utilization metrics.

``forward_macs`` walks a configuration's topology (arch.py) on meta tensors
and counts each layer's multiply-adds from its shapes: a conv's
``k * k * Cin * Cout * Ho * Wo``, a transposed conv's ``k * k * Cin * Cout
* Hin * Win``, a linear's ``rows * Cin * Cout``, attention's two products
``2 * T * T * D`` a crop, grouped by the kind of layer (trunk conv, head
transposed conv, final conv, linear, attention), so each kind can be held
to the peak of the precision the configuration runs it in.  Nothing is
recounted for padding, nothing for BatchNorm, LayerNorm, GELU, ReLU or
sums.  ``MacCounter.bytes`` keeps each kind's least bytes at the counter's
`itemsize`: every input, weight and output read or written once
(attention's scores never leave the chip; LayerNorm and GELU move their
input and output).  ``decode_bytes`` is K1's traffic: each
heatmap row read once (float32) and its packed row of 8 float32 written.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import arch


class MacCounter:
    """An arithmetic that only propagates shapes (meta tensors) and counts
    multiply-adds per crop by kind: ``conv``, ``deconv``, ``final``, and
    where the topology has them ``linear`` and ``attention``; ``bytes``
    the least bytes by kind (also ``layer_norm``, ``gelu``), each element
    `itemsize` bytes."""

    def __init__(self, itemsize: int = 2):
        self.macs: Dict[str, int] = {"conv": 0, "deconv": 0, "final": 0}
        self.bytes: Dict[str, int] = {}
        self.itemsize = int(itemsize)

    def _count(self, kind: str, macs: int, *moved) -> None:
        if macs:
            self.macs[kind] = self.macs.get(kind, 0) + int(macs)
        elements = sum(int(m.numel()) if isinstance(m, torch.Tensor) else int(m) for m in moved)
        self.bytes[kind] = self.bytes.get(kind, 0) + self.itemsize * elements

    def unit(self, P, conv, bn, x, cin, cout, k, stride, relu):
        w = P.conv(conv, cout, cin, k)
        P.bn(bn, cout)
        y = F.conv2d(x, w, stride=stride, padding=k // 2)
        self._count("conv", k * k * cin * cout * y.shape[2] * y.shape[3], x, w, y)
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
        y = F.conv_transpose2d(x, w, stride=2, padding=(k - 2) // 2)
        self._count("deconv", k * k * cin * cout * x.shape[2] * x.shape[3], x, w, y)
        return y

    def final(self, P, name, x, cin, cout, k):
        w = P.conv(name, cout, cin, k, kind="head")
        P.get(name + ".bias", (cout,), "bias")
        y = F.conv2d(x, w, padding=1 if k == 3 else 0)
        self._count("final", k * k * cin * cout * y.shape[2] * y.shape[3], x, w, y)
        return y

    def linear(self, P, name, x, cin, cout, bias: bool = True, shape=None):
        w, b = P.linear(name, cout, cin, bias, shape)
        y = F.linear(x, w, b)
        self._count("linear", x.numel() // cin * cin * cout, x, w, y, 0 if b is None else b)
        return y

    def layer_norm(self, P, name, x, dim, eps: float = 1e-6):
        gamma, beta = P.norm(name, dim)
        self._count("layer_norm", 0, x, x, gamma, beta)
        return torch.empty_like(x)

    def gelu(self, x):
        self._count("gelu", 0, x, x)
        return torch.empty_like(x)

    def attention(self, q, k, v, heads: int, scale=None):
        n, length, d = q.shape
        self._count("attention", 2 * length * k.shape[1] * d, q, k, v, q)
        return torch.empty_like(q)


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
    return factor * sum(2.0 * n / peaks[precision[kind]] for kind, n in macs.items() if n)


def decode_bytes(rows: int, row_len: int) -> int:
    """K1's bytes for `rows` float32 heatmap rows of `row_len` values: each
    read once, and the packed [rows, 8] float32 result written once."""
    return rows * row_len * 4 + rows * 8 * 4
