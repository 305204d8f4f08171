"""Flax PoseResNet parameters -> a torch state_dict for this package.

The port's own copy of the JAX package's ``flax_to_torch_state_dict`` for
POSE_RESNET (models/convert.py there).  It takes plain nested dicts of numpy
arrays, so it needs neither JAX nor flax:

  Conv kernel [kh, kw, I, O]          -> Conv2d weight [O, I, kh, kw]
  ConvTranspose kernel [kh, kw, I, O] -> ConvTranspose2d weight [I, O, kh, kw],
    spatial taps rotated 180 degrees (flax's conv_transpose is a conv of
    the dilated input with the rotated kernel)
  BN scale/bias -> weight/bias; batch_stats mean/var -> running_mean/var.

Module names map flax -> torch as in the reference:
  layer{s}_{i}/conv{j}|bn{j}         -> layer{s}.{i}.conv{j}|bn{j}
  layer{s}_{i}/downsample_conv|bn    -> layer{s}.{i}.downsample.0|1
  deconv{i} / deconv_bn{i}           -> deconv_layers.{3i} / deconv_layers.{3i+1}
  conv1, bn1, final_layer            -> the same names
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {
    "kernel": "weight", "scale": "weight", "bias": "bias",
    "mean": "running_mean", "var": "running_var",
}


def conv_weight_to_torch(k: np.ndarray) -> np.ndarray:
    """[kh, kw, I, O] -> [O, I, kh, kw]."""
    return np.transpose(k, (3, 2, 0, 1))


def deconv_weight_to_torch(k: np.ndarray) -> np.ndarray:
    """[kh, kw, I, O] -> [I, O, kh, kw], spatially rotated 180 degrees."""
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _torch_module_name(path: Tuple[str, ...]) -> str:
    mod = "/".join(path)
    m = re.fullmatch(r"layer(\d+)_(\d+)/(conv\d|bn\d)", mod)
    if m:
        return "layer%s.%s.%s" % m.groups()
    m = re.fullmatch(r"layer(\d+)_(\d+)/downsample_(conv|bn)", mod)
    if m:
        idx = "0" if m.group(3) == "conv" else "1"
        return "layer%s.%s.downsample.%s" % (m.group(1), m.group(2), idx)
    m = re.fullmatch(r"deconv(\d)", mod)
    if m:
        return "deconv_layers.%d" % (int(m.group(1)) * 3)
    m = re.fullmatch(r"deconv_bn(\d)", mod)
    if m:
        return "deconv_layers.%d" % (int(m.group(1)) * 3 + 1)
    if mod in ("conv1", "bn1", "final_layer"):
        return mod
    raise KeyError("Unmapped PoseResNet module: %s" % mod)


def from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax PoseResNet (params, batch_stats) -> {torch name: float32 tensor}.

    Accepts any nested mapping of array-likes (numpy arrays as the tests
    pass them).  ``PoseResNet.load_state_dict(..., strict=True)`` accepts the
    result."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            name = "%s.%s" % (_torch_module_name(path), _LEAF[key])
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                if name.startswith("deconv_layers"):
                    arr = deconv_weight_to_torch(arr)
                else:
                    arr = conv_weight_to_torch(arr)
            out[name] = torch.from_numpy(np.array(arr, order="C"))  # own copy

    walk(params, ())
    walk(batch_stats, ())
    return out


def scales_from_jax(table: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """An int8 activation-scale table of the JAX package (name -> scalar
    array, from its ``int8_calibrate``) -> {name: float32 scalar tensor},
    the ``int8_scales`` the port's engine and int8 forward take."""
    return {
        name: torch.as_tensor(np.asarray(value, dtype=np.float32), device=device)
        for name, value in table.items()
    }
