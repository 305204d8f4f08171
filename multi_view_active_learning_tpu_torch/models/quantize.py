"""Int8 PoseResNet and HRNet inference for the scoring / eval path.

The port of the JAX package's models/quantize.py:

  * weights: symmetric per-output-channel s8, quantized once from the
    float32 weights (``quantize_state_dict``, at every weight load);
  * activations: symmetric per-tensor s8, ``round(x / sx)`` clipped to
    +-127, with ``sx`` dynamic (max|x| / 127 of each conv input, the max
    taken over every rank's rows under a process group), static (a table
    from a ``collect_scales=True`` calibration pass), or recorded;
  * each conv is one int8 conv unit, K5 (kernels/int8_conv.py): the
    activation's quantize, an s8 product (channels-last, s32 accumulation,
    exact), one float32 epilogue that folds the BN, ``acc * (sx * ws *
    bn_scale) + bn_bias`` (+ ReLU), rounded to bf16, and a block's residual
    add and ReLU after its last conv; on the CPU its plain twin (an s8 im2col
    product through ``torch._int_mm``), on a card the kernel;
  * the maxpool runs in bf16 between blocks;
    ``float_tail_stages`` runs the last stages' convs in bf16 instead;
  * the deconv head runs the bf16 ``conv_transpose`` by default, or K4
    (kernels/deconv.py::fused_deconv_bn_relu_int8) with ``int8_head``;
  * the final 1x1 runs in float32;
  * HRNet (``quantized_hrnet_forward``): every conv int8 with folded BN, the
    exchange units' sums in float32 then ReLU then bf16, the nearest
    upsample a repeat, the final conv in float32.  HRNet has no deconv
    head, so no K4.

Activations are NHWC here; the scale-table keys are the JAX package's
(PoseResNet: ``"stem"``, ``"layerS_I/conv1..3"``, ``"layerS_I/down"``,
``"deconv{i}"``; HRNet: ``"stem1"``, ``"stem2"``, ``"layer1_I/..."``,
``"stageS_moduleM/branchB_blockI/..."``, ``".../fuseI_J"``,
``".../fuseI_J_K"``, ``"transitionT_I"``, ``"transitionT_I_J"``), so a table
calibrated by the JAX package drops in.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from .. import parallel
from ..kernels import deconv, int8_conv
from .pose_resnet import RESNET_SPEC, BasicBlock

_BF16 = torch.bfloat16


def _quant_weight(w: torch.Tensor):
    """Conv2d weight [Cout, Cin, kh, kw] float -> (s8 weights of the same
    layout, per-Cout float32 scale).  The output channel is dim 0."""
    w = w.to(torch.float32)
    ws = torch.clamp(torch.amax(torch.abs(w), dim=(1, 2, 3)), min=1e-8) / 127.0
    wq = torch.clamp(torch.round(w / ws[:, None, None, None]), -127, 127).to(torch.int8)
    return wq, ws


class _ActScales:
    """Per-tensor activation scales: dynamic, static, or collecting."""

    def __init__(self, table: Optional[Mapping[str, torch.Tensor]] = None, collect: bool = False):
        self.table = table
        self.collect = collect
        self.recorded: Dict[str, torch.Tensor] = {}

    def scale_for(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.table is not None:
            return self.table[name]
        # Under a process group the maximum over every rank's rows: the
        # global batch's scale, as JAX computes it on a sharded batch.
        amax = parallel.all_reduce_max(torch.amax(torch.abs(x.to(torch.float32))))
        sx = torch.clamp(amax, min=1e-8) / 127.0
        if self.collect:
            self.recorded[name] = sx
        return sx


# The plain twin's pieces (kernels/int8_conv.py), under the names the tests use.
_quant_act = int8_conv.quant_act
_int8_conv = int8_conv.int8_conv_s32
_residual_relu = int8_conv.residual_relu


def _qconv_bn(x, qp, conv: str, bn: str, scales: _ActScales, name: str,
              stride: int = 1, relu: bool = True, residual=None) -> torch.Tensor:
    """int8 conv + folded BN (+ ReLU), then with `residual` relu(. +
    residual), returning bf16 NHWC: one K5 unit."""
    sx = scales.scale_for(name, x)
    return int8_conv.int8_conv_bn(x, qp[conv + ".wq"], qp[conv + ".ws"], qp[bn + ".scale"],
                                  qp[bn + ".bias"], sx, residual, stride, relu=relu)


def _fconv_bn(x, qp, conv: str, bn: str, scales, name, stride: int = 1,
              relu: bool = True, residual=None) -> torch.Tensor:
    """bf16 conv + folded BN (+ ReLU) (+ the residual's add and ReLU): the
    float twin of _qconv_bn for the mixed-precision tail (``scales`` and
    ``name`` are not used)."""
    w = qp[conv + ".weight"]
    y = F.conv2d(x.to(_BF16).permute(0, 3, 1, 2), w, stride=stride, padding=w.shape[-1] // 2)
    y = y.permute(0, 2, 3, 1).to(torch.float32) * qp[bn + ".scale"] + qp[bn + ".bias"]
    if relu:
        y = torch.relu(y)
    y = y.to(_BF16)
    return y if residual is None else _residual_relu(y, residual)


def _basic_block(x, qp, conv_bn: Callable, scales, tname, prefix, stride, downsample):
    out = conv_bn(x, qp, tname + ".conv1", tname + ".bn1", scales, prefix + "/conv1", stride)
    residual = x
    if downsample:
        residual = conv_bn(x, qp, tname + ".downsample.0", tname + ".downsample.1", scales,
                           prefix + "/down", stride, relu=False)
    return conv_bn(out, qp, tname + ".conv2", tname + ".bn2", scales, prefix + "/conv2",
                   relu=False, residual=residual)


def _bottleneck_block(x, qp, conv_bn: Callable, scales, tname, prefix, stride, downsample):
    out = conv_bn(x, qp, tname + ".conv1", tname + ".bn1", scales, prefix + "/conv1")
    out = conv_bn(out, qp, tname + ".conv2", tname + ".bn2", scales, prefix + "/conv2", stride)
    residual = x
    if downsample:
        residual = conv_bn(x, qp, tname + ".downsample.0", tname + ".downsample.1", scales,
                           prefix + "/down", stride, relu=False)
    return conv_bn(out, qp, tname + ".conv3", tname + ".bn3", scales, prefix + "/conv3",
                   relu=False, residual=residual)


def _convs_and_bns(num_layers: int):
    """(conv names, BN names) of the torch PoseResNet, head included."""
    block_cls, layer_sizes = RESNET_SPEC[num_layers]
    convs, bns = ["conv1"], ["bn1"]
    n_convs = 2 if block_cls is BasicBlock else 3
    for stage, blocks in enumerate(layer_sizes):
        for i in range(blocks):
            t = "layer%d.%d" % (stage + 1, i)
            convs += ["%s.conv%d" % (t, j + 1) for j in range(n_convs)]
            bns += ["%s.bn%d" % (t, j + 1) for j in range(n_convs)]
            if i == 0:
                convs.append(t + ".downsample.0")
                bns.append(t + ".downsample.1")
    convs += ["deconv_layers.%d" % (3 * i) for i in range(3)]
    bns += ["deconv_layers.%d" % (3 * i + 1) for i in range(3)]
    return convs, bns


def _hrnet_convs_and_bns(state_dict: Mapping[str, torch.Tensor]):
    """(conv names, BN names) of a reference-named HRNet state dict: every
    4-D weight but the final layer's is a conv, and its BN is named by the
    reference's rule (``...conv{j}`` -> ``...bn{j}``, ``....0`` -> ``....1``)."""
    convs = [k[:-len(".weight")] for k, v in state_dict.items()
             if k.endswith(".weight") and v.dim() == 4 and k != "final_layer.weight"]
    bns = []
    for conv in convs:
        head, _, leaf = conv.rpartition(".")
        if leaf.startswith("conv"):
            bns.append(("%s.bn%s" % (head, leaf[4:])).lstrip("."))
        elif leaf == "0":
            bns.append(head + ".1")
        else:
            raise KeyError("no BN for HRNet conv %s" % conv)
    return convs, bns


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor], num_layers: int,
                        int8_head: bool = False,
                        model_type: str = "POSE_RESNET") -> Dict[str, torch.Tensor]:
    """Reference-named float weights -> what the int8 forward reads, on the
    weights' device:

      ``<conv>.wq`` [Cout, k, k, Cin] s8 (channels last) and ``<conv>.ws``
      [Cout] for every backbone conv;
      ``<conv>.weight`` in bf16 for every conv (the float tail and the bf16
      head); ``deconv_layers.{3i}.wq`` / ``.ws`` (torch layout) and
      ``.wpk`` (K4's packed weights, kernels/deconv.py::pack_weight) with
      ``int8_head``; ``<bn>.scale`` / ``.bias``, the float32 BN folds; and
      ``final_layer.weight`` / ``.bias`` in float32.

    Quantizes the weights as given, so pass the float32 state dict (the
    JAX package quantizes float32 parameters).  ``model_type="HRNET"``
    takes the HRNet's convs and BNs from the state dict's names
    (``num_layers`` and ``int8_head`` do not apply)."""
    if model_type == "HRNET":
        convs, bns = _hrnet_convs_and_bns(state_dict)
    else:
        convs, bns = _convs_and_bns(num_layers)
    out: Dict[str, torch.Tensor] = {}
    for conv in convs:
        if conv + ".weight" not in state_dict:
            continue  # a first block without a downsample
        w = state_dict[conv + ".weight"].to(torch.float32)
        out[conv + ".weight"] = w.to(_BF16)
        if conv.startswith("deconv_layers"):
            if int8_head:
                out[conv + ".wq"], out[conv + ".ws"] = deconv.quantize_deconv_weight(w)
                out[conv + ".wpk"] = deconv.pack_weight(out[conv + ".wq"])
            continue
        wq, ws = _quant_weight(w)
        out[conv + ".wq"] = wq.permute(0, 2, 3, 1).contiguous()
        out[conv + ".ws"] = ws
    for bn in bns:
        if bn + ".weight" not in state_dict:
            continue
        out[bn + ".scale"], out[bn + ".bias"] = deconv.fold_bn(
            *(state_dict[bn + "." + k].to(torch.float32)
              for k in ("weight", "bias", "running_mean", "running_var")))
    out["final_layer.weight"] = state_dict["final_layer.weight"].to(torch.float32)
    out["final_layer.bias"] = state_dict["final_layer.bias"].to(torch.float32)
    return out


def _stem_conv(wq: torch.Tensor, cin: int):
    """PoseResNet's s8 stem as (weights, stride, pad) for an input of `cin`
    channels: the 7x7 stride-2 conv padded 3 on 3 channels; on a
    space-to-depth'd [N, H/2, W/2, 12] input (TPU.SPACE_TO_DEPTH_STEM) the s8
    weights through SpaceToDepthStem's remap, a 4x4 stride-1 conv padded
    (2, 1) (JAX models/quantize.py:236-245): the remap only moves and
    zero-pads weights, so quantization commutes with it, the per-channel
    scales stay, and the s32 sums hold the same products."""
    if cin != 4 * wq.shape[-1]:
        return wq, 2, (wq.shape[1] // 2, wq.shape[1] // 2)
    co, ci = wq.shape[0], wq.shape[-1]
    wp = F.pad(wq, (0, 0, 1, 0, 1, 0))  # [co, 8, 8, ci]
    wq = wp.reshape(co, 4, 2, 4, 2, ci).permute(0, 1, 3, 2, 4, 5).reshape(co, 4, 4, 4 * ci)
    return wq.contiguous(), 1, (2, 1)


def quantized_pose_resnet_forward(qp: Mapping[str, torch.Tensor], images: torch.Tensor,
                                  num_layers: int, act_scales=None, collect_scales: bool = False,
                                  int8_head: bool = False, float_tail_stages: int = 0):
    """Int8 inference forward: normalized images NHWC [N, H, W, 3] ->
    heatmaps NCHW [N, K, H/4, W/4] float32.

    ``qp``: ``quantize_state_dict``'s output.  ``act_scales``: a static
    scale table (the dict a ``collect_scales=True`` call returns, or one
    carried from the JAX package by ``convert.scales_from_jax``); with
    ``collect_scales=True`` the return value is ``(heatmaps, scales)``.
    ``int8_head`` runs the deconv head through K4.  ``float_tail_stages``
    runs the last n of the four residual stages in bf16."""
    block_cls, layer_sizes = RESNET_SPEC[num_layers]
    scales = _ActScales(act_scales, collect_scales)
    x = images.to(_BF16).contiguous()

    # Stem: 7x7/s2 int8 conv + BN + ReLU (one K5 unit), then the 3x3/s2
    # maxpool (-inf pad).
    sx = scales.scale_for("stem", x)
    wq, stride, pad = _stem_conv(qp["conv1.wq"], x.shape[-1])
    x = int8_conv.int8_conv_bn(x, wq, qp["conv1.ws"], qp["bn1.scale"], qp["bn1.bias"], sx, None,
                               stride, pad)
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1).contiguous()

    block_fn = _basic_block if block_cls is BasicBlock else _bottleneck_block
    expansion = block_cls.expansion
    inplanes = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layer_sizes)):
        stride = 1 if stage == 0 else 2
        conv_bn = _fconv_bn if stage >= 4 - int(float_tail_stages) else _qconv_bn
        for i in range(blocks):
            downsample = i == 0 and (stride != 1 or inplanes != planes * expansion)
            x = block_fn(x, qp, conv_bn, scales, "layer%d.%d" % (stage + 1, i),
                         "layer%d_%d" % (stage + 1, i), stride if i == 0 else 1, downsample)
        inplanes = planes * expansion

    # Head: ConvTranspose + folded BN + ReLU, bf16 (cuDNN) or K4.
    for i in range(3):
        conv, bn = "deconv_layers.%d" % (3 * i), "deconv_layers.%d" % (3 * i + 1)
        if int8_head:
            sx = scales.scale_for("deconv%d" % i, x)
            ops = deconv.K4Operands(qp[conv + ".wq"], qp[conv + ".ws"], qp[bn + ".scale"],
                                    qp[bn + ".bias"], qp[conv + ".wpk"])
            x = deconv.fused_deconv_bn_relu_int8_packed(x.contiguous(), ops, sx)
        else:
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), qp[conv + ".weight"], stride=2, padding=1)
            y = y.permute(0, 2, 3, 1).to(torch.float32) * qp[bn + ".scale"] + qp[bn + ".bias"]
            x = torch.relu(y).to(_BF16)

    out = deconv.final_1x1(x, qp["final_layer.weight"], qp["final_layer.bias"])
    if collect_scales:
        return out, scales.recorded
    return out


def _upsample_nhwc(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest upsample of NHWC by an integer factor: exact copies."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def quantized_hrnet_forward(qp: Mapping[str, torch.Tensor], images: torch.Tensor,
                            stage2, stage3, stage4, final_conv_kernel: int = 1,
                            act_scales=None, collect_scales: bool = False):
    """Int8 HRNet inference forward: normalized images NHWC [N, H, W, 3] ->
    heatmaps NCHW [N, K, H/4, W/4] float32 (the JAX package's
    ``quantized_hrnet_forward``, models/quantize.py:340-475).

    ``qp``: ``quantize_state_dict(..., model_type="HRNET")``'s output.
    Stages in the (num_modules, num_branches, block, num_blocks,
    num_channels) encoding.  ``act_scales`` / ``collect_scales`` as in
    ``quantized_pose_resnet_forward``."""
    scales = _ActScales(act_scales, collect_scales)
    x = images.to(_BF16).contiguous()
    for i in (1, 2):
        x = _qconv_bn(x, qp, "conv%d" % i, "bn%d" % i, scales, "stem%d" % i, 2)
    for i in range(4):
        x = _bottleneck_block(x, qp, _qconv_bn, scales, "layer1.%d" % i, "layer1_%d" % i, 1, i == 0)

    prev, ys = [256], [x]
    for s, (num_modules, num_branches, block, num_blocks, num_channels) in (
            (2, stage2), (3, stage3), (4, stage4)):
        block_fn = _basic_block if block == "BASIC" else _bottleneck_block
        cur = [c * (1 if block == "BASIC" else 4) for c in num_channels]
        xs = []
        for i in range(num_branches):
            tn, tk = "transition%d.%d" % (s - 1, i), "transition%d_%d" % (s - 1, i)
            if i < len(prev):
                y = ys[i]
                if cur[i] != prev[i]:
                    y = _qconv_bn(y, qp, tn + ".0", tn + ".1", scales, tk)
            else:
                y = ys[-1]
                for j in range(i + 1 - len(prev)):
                    y = _qconv_bn(y, qp, "%s.%d.0" % (tn, j), "%s.%d.1" % (tn, j), scales,
                                  "%s_%d" % (tk, j), 2)
            xs.append(y)
        inchannels = list(cur)
        for m in range(num_modules):
            mod, mk = "stage%d.%d" % (s, m), "stage%d_module%d" % (s, m)
            for b in range(num_branches):
                for i in range(num_blocks[b]):
                    xs[b] = block_fn(xs[b], qp, _qconv_bn, scales,
                                     "%s.branches.%d.%d" % (mod, b, i),
                                     "%s/branch%d_block%d" % (mk, b, i), 1,
                                     i == 0 and inchannels[b] != cur[b])
            if num_branches > 1:
                multi_scale = not (s == 4 and m == num_modules - 1)
                xs = _exchange(xs, qp, scales, mod, mk, num_branches if multi_scale else 1)
            inchannels = list(cur)
        ys, prev = xs, cur

    w = qp["final_layer.weight"]
    if w.shape[-1] == 1:
        out = deconv.final_1x1(ys[0], w, qp["final_layer.bias"])
    else:
        out = F.conv2d(ys[0].to(torch.float32).permute(0, 3, 1, 2), w, qp["final_layer.bias"],
                       padding=final_conv_kernel // 2)
    if collect_scales:
        return out, scales.recorded
    return out


def _exchange(ys, qp, scales, mod: str, mk: str, num_out: int):
    """An HRNet exchange unit in int8: each output branch sums, in float32,
    every branch carried to its resolution (1x1 int8 conv + BN + nearest
    upsample from below, int8 stride-2 3x3 chains from above, ReLU on all
    but the last step), then ReLU and bf16 (models/quantize.py:383-417)."""
    fused = []
    for i in range(num_out):
        acc = None
        for j, y in enumerate(ys):
            fl = "%s.fuse_layers.%d.%d" % (mod, i, j)
            if j > i:
                y = _qconv_bn(y, qp, fl + ".0", fl + ".1", scales, "%s/fuse%d_%d" % (mk, i, j),
                              relu=False)
                y = _upsample_nhwc(y, 2 ** (j - i))
            elif j < i:
                for k in range(i - j):
                    y = _qconv_bn(y, qp, "%s.%d.0" % (fl, k), "%s.%d.1" % (fl, k), scales,
                                  "%s/fuse%d_%d_%d" % (mk, i, j, k), 2, relu=k != i - j - 1)
            acc = y.to(torch.float32) if acc is None else acc + y.to(torch.float32)
        fused.append(torch.relu(acc).to(_BF16))
    return fused
