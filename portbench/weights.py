"""Seeded weights for a configuration, made on the device in a few calls.

The parameter list comes from the benchmark's own topology (reference/
arch.py), under the reference repo's module names, which the port loads
as they are.  Every conv, transposed-conv and linear weight is drawn N(0,
1 / fan_in) (fan-in scaled, as lecun_normal without its truncation), the
final conv N(0, 0.0004 / fan_in), a learned table (kind ``table``, a
position embedding) N(0, 0.02^2); BatchNorm and LayerNorm scale 1, shift
0, running mean 0 and variance 1; biases 0.
One normal draw from a ``torch.Generator`` on the device covers every
weight, scaled by one per-element vector; the state dict's tensors are
views of that one float32 buffer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

HEAD_GAIN = 0.02
TABLE_STD = 0.02
DRAWN = ("conv", "head", "linear", "table")


def _std(shape: Tuple[int, ...], kind: str) -> float:
    """1 / sqrt(fan_in), fan_in the product of shape[1:] as torch counts it
    (shape[1] * kh * kw for a conv, and for a transposed conv's [Cin, Cout,
    kh, kw] weight too; a linear's [out, in] weight reads `in`); the final
    conv at HEAD_GAIN times that, so its heatmaps start small (a loss far
    under TRAIN.LOSS_CLIP_VALUE) but not negligible against the targets; a
    table TABLE_STD."""
    if kind == "table":
        return TABLE_STD
    fan_in = math.prod(shape[1:])
    return (HEAD_GAIN if kind == "head" else 1.0) / math.sqrt(fan_in)


def make_state_dict(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """`spec`: (name, shape, kind) from ``arch.Params``; kinds ``DRAWN``
    are drawn, the rest are constants."""
    device = torch.device(device)
    drawn = [(n, s, k) for n, s, k in spec if k in DRAWN]
    sizes = [math.prod(s) for _, s, _ in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    stds = torch.tensor([_std(s, k) for _, s, k in drawn], dtype=torch.float32, device=device)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(sizes, device=device)))
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (name, shape, _), size in zip(drawn, sizes):
        out[name] = flat[offset:offset + size].view(shape)
        offset += size
    consts = {"weight": 1.0, "running_var": 1.0, "bias": 0.0, "running_mean": 0.0}
    fixed = [(n, s, k) for n, s, k in spec if k in consts]
    sizes = [math.prod(s) for _, s, _ in fixed]
    values = torch.tensor([consts[k] for _, _, k in fixed], dtype=torch.float32, device=device)
    flat = torch.repeat_interleave(values, torch.tensor(sizes, device=device))
    offset = 0
    for (name, shape, _), size in zip(fixed, sizes):
        out[name] = flat[offset:offset + size].view(shape)
        offset += size
    counts = torch.zeros(sum(k == "count" for _, _, k in spec), dtype=torch.int64, device=device)
    for i, name in enumerate(n for n, _, k in spec if k == "count"):
        out[name] = counts[i]
    return {name: out[name] for name, _, _ in spec}
