"""Flax PoseResNet / HRNet parameters -> a torch state_dict for this package.

The port's own copy of the JAX package's ``flax_to_torch_state_dict``
(models/convert.py there, ``_flax_to_torch_name`` at :218-290).  It takes
plain nested dicts of numpy arrays, so it needs neither JAX nor flax:

  Conv kernel [kh, kw, I, O]          -> Conv2d weight [O, I, kh, kw]
  ConvTranspose kernel [kh, kw, I, O] -> ConvTranspose2d weight [I, O, kh, kw],
    spatial taps rotated 180 degrees (flax's conv_transpose is a conv of
    the dilated input with the rotated kernel)
  BN scale/bias -> weight/bias; batch_stats mean/var -> running_mean/var.

Module names map flax -> torch as in the reference.  PoseResNet:
  layer{s}_{i}/conv{j}|bn{j}         -> layer{s}.{i}.conv{j}|bn{j}
  layer{s}_{i}/downsample_conv|bn    -> layer{s}.{i}.downsample.0|1
  deconv{i} / deconv_bn{i}           -> deconv_layers.{3i} / deconv_layers.{3i+1}
  conv1, bn1, final_layer            -> the same names
HRNet:
  conv1, bn1, conv2, bn2, final_layer          -> the same names
  layer1_{i}/conv{j}|bn{j}, /downsample_conv|bn -> layer1.{i}.conv{j}|bn{j}, .downsample.0|1
  transition{t}_{i}_conv|bn                    -> transition{t}.{i}.0|1
  transition{t}_{i}_conv{j}|bn{j}              -> transition{t}.{i}.{j}.0|1
  stage{s}_module{m}/branch{b}_block{i}/...    -> stage{s}.{m}.branches.{b}.{i}....
  stage{s}_module{m}/fuse{i}_{j}_conv|bn       -> stage{s}.{m}.fuse_layers.{i}.{j}.0|1
  stage{s}_module{m}/fuse{i}_{j}_conv{k}|bn{k} -> stage{s}.{m}.fuse_layers.{i}.{j}.{k}.0|1
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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


def _conv_or_bn(kind: str) -> str:
    return "0" if kind == "conv" else "1"


def _pose_resnet_name(mod: str) -> str:
    m = re.fullmatch(r"layer(\d+)_(\d+)/(conv\d|bn\d)", mod)
    if m:
        return "layer%s.%s.%s" % m.groups()
    m = re.fullmatch(r"layer(\d+)_(\d+)/downsample_(conv|bn)", mod)
    if m:
        return "layer%s.%s.downsample.%s" % (m.group(1), m.group(2), _conv_or_bn(m.group(3)))
    m = re.fullmatch(r"deconv(\d)", mod)
    if m:
        return "deconv_layers.%d" % (int(m.group(1)) * 3)
    m = re.fullmatch(r"deconv_bn(\d)", mod)
    if m:
        return "deconv_layers.%d" % (int(m.group(1)) * 3 + 1)
    if mod in ("conv1", "bn1", "final_layer"):
        return mod
    raise KeyError("Unmapped PoseResNet module: %s" % mod)


def _hrnet_name(mod: str) -> str:
    if mod in ("conv1", "bn1", "conv2", "bn2", "final_layer"):
        return mod
    m = re.fullmatch(r"layer1_(\d+)/(conv\d|bn\d)", mod)
    if m:
        return "layer1.%s.%s" % m.groups()
    m = re.fullmatch(r"layer1_(\d+)/downsample_(conv|bn)", mod)
    if m:
        return "layer1.%s.downsample.%s" % (m.group(1), _conv_or_bn(m.group(2)))
    m = re.fullmatch(r"transition(\d)_(\d+)_(conv|bn)", mod)
    if m:
        return "transition%s.%s.%s" % (m.group(1), m.group(2), _conv_or_bn(m.group(3)))
    m = re.fullmatch(r"transition(\d)_(\d+)_(conv|bn)(\d+)", mod)
    if m:
        return "transition%s.%s.%s.%s" % (m.group(1), m.group(2), m.group(4),
                                         _conv_or_bn(m.group(3)))
    m = re.fullmatch(r"stage(\d)_module(\d+)/branch(\d+)_block(\d+)/(conv\d|bn\d)", mod)
    if m:
        return "stage%s.%s.branches.%s.%s.%s" % m.groups()
    m = re.fullmatch(r"stage(\d)_module(\d+)/branch(\d+)_block(\d+)/downsample_(conv|bn)", mod)
    if m:
        return "stage%s.%s.branches.%s.%s.downsample.%s" % (
            m.group(1), m.group(2), m.group(3), m.group(4), _conv_or_bn(m.group(5)))
    m = re.fullmatch(r"stage(\d)_module(\d+)/fuse(\d+)_(\d+)_(conv|bn)", mod)
    if m:
        return "stage%s.%s.fuse_layers.%s.%s.%s" % (
            m.group(1), m.group(2), m.group(3), m.group(4), _conv_or_bn(m.group(5)))
    m = re.fullmatch(r"stage(\d)_module(\d+)/fuse(\d+)_(\d+)_(conv|bn)(\d+)", mod)
    if m:
        return "stage%s.%s.fuse_layers.%s.%s.%s.%s" % (
            m.group(1), m.group(2), m.group(3), m.group(4), m.group(6), _conv_or_bn(m.group(5)))
    raise KeyError("Unmapped HRNet module: %s" % mod)


_NAMES = {"POSE_RESNET": _pose_resnet_name, "HRNET": _hrnet_name}


def from_flax(params: Mapping, batch_stats: Mapping,
              model_type: str = "POSE_RESNET") -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) of a PoseResNet or an HRNet ->
    {torch name: float32 tensor}.

    Accepts any nested mapping of array-likes (numpy arrays as the tests
    pass them).  ``PoseResNet`` / ``PoseHighResolutionNet``
    ``.load_state_dict(..., strict=True)`` accepts the result."""
    module_name = _NAMES[model_type]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            name = "%s.%s" % (module_name("/".join(path)), _LEAF[key])
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
        name: torch.as_tensor(np.array(value, dtype=np.float32), device=device)
        for name, value in table.items()
    }
