"""Serving export: freeze a model into a ``torch.export`` artifact (``.pt2``).

The port of the JAX package's serving.py.  The serve function is the
inference contract, with the weights baked in:

    (images uint8 [B, V, H, W, 3], square_box f32 [B, V, 4])
      -> {"heatmaps":   f32 [B, V, h, w, K]  (the JAX package's NHWC order),
          "keypoints":  f32 [B, V, K, 2]     (bbox-relative pixels,
                                              ``decode_keypoints_bbox``),
          "confidence": f32 [B, V, K]        (each heatmap's peak)}

``build_serve_fn`` makes it an ``nn.Module`` that holds the model, the
normalization constants, the K3 packs (``TPU.PALLAS_HEAD``), and with
``int8_scales`` the quantized backbone (s8 weights, folded BNs, K4's packs
under ``TPU.INT8_DECONV``) and the static activation scales, as parameters
and buffers.  Its forward runs the engine's inference routing without the
engine's ``torch.inference_mode`` decorators, so ``torch.export`` traces it;
one K1 launch (``torch.ops.mval.fused_decode``) gives both the keypoints
and the confidence.

``export_serving`` traces it into a ``torch.export.ExportedProgram`` (the
batch dimension static, or symbolic with ``batch_size=None``; views, image
size and joints static, as in the JAX package), ``save_serving`` writes the
``.pt2`` and ``load_serving`` reads it back as a callable.

What an artifact needs to load: torch (a ``.pt2`` is tied to the torch
version that wrote it) and the kernels' operator registrations
(``multi_view_active_learning_tpu_torch.kernels``, which ``load_serving``
imports), not the config, the engine, the models or a checkpoint.  The
JAX package's StableHLO artifact needs only JAX; the kernels here are
operators of this package, so its kernel registrations travel with the
artifact's loader.  The artifact runs on the device type it was exported
on (export on the card to serve on the card).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from . import kernels  # registers torch.ops.mval, which an artifact calls
from .device import resolve_device
from .ops import heatmap as heatmap_ops
from .ops.image import space_to_depth
from .utils import get_logger

_logger = get_logger(__name__)

SERVING_SUFFIX = ".pt2"
META_FILE = "mval_serving.json"  # the artifact's description, saved beside the graph


class _Tensors(nn.Module):
    """A name -> tensor table held as buffers (buffer names may not hold
    dots, the table's keys do)."""

    def __init__(self, table: Mapping[str, torch.Tensor]):
        super().__init__()
        self.keys = list(table)
        for i, key in enumerate(self.keys):
            self.register_buffer("t%d" % i, torch.as_tensor(table[key]).detach().clone())

    def table(self) -> Dict[str, torch.Tensor]:
        return {key: getattr(self, "t%d" % i) for i, key in enumerate(self.keys)}


def _int8_weights_read(qp: Mapping[str, torch.Tensor], model_type: str, int8_head: bool,
                       float_tail: int) -> Dict[str, torch.Tensor]:
    """The entries of ``quantize_state_dict``'s table that the int8 forward
    reads: the bf16 copies of the convolutions only for the bf16 head and
    the float tail's stages (the artifact carries nothing else)."""
    tail = tuple("layer%d." % s for s in range(5 - float_tail, 5)) if float_tail else ()

    def read(key: str) -> bool:
        if not key.endswith(".weight") or key.startswith("final_layer."):
            return True
        if key.startswith("deconv_layers."):
            return not int8_head
        return model_type == "POSE_RESNET" and bool(tail) and key.startswith(tail)

    return {k: v for k, v in qp.items() if read(k)}


class ServeModule(nn.Module):
    """The serve function of an engine's current weights (a frozen copy).

    The forward routes as ``Engine.forward`` does: the int8 backbone when
    built with static scales (with K4's head under ``TPU.INT8_DECONV``),
    else the float trunk with K3's head under ``TPU.PALLAS_HEAD``
    (PoseResNet), else the float model; under ``TPU.SPACE_TO_DEPTH_STEM``
    (PoseResNet) the frames are space-to-depth'd before normalization, as
    ``Engine._flatten_normalize`` does."""

    def __init__(self, engine, int8_scales: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        self.dtype = engine.dtype
        self.s2d_stem = (bool(engine.cfg.TPU.SPACE_TO_DEPTH_STEM)
                         and engine.model_type == "POSE_RESNET")
        self.register_buffer("mean", engine._mean.detach().clone())
        self.register_buffer("std", engine._std.detach().clone())
        self.use_int8 = int8_scales is not None
        if self.use_int8:
            if engine._int8_weights is None:
                raise ValueError(
                    "int8_scales need an engine with the int8 backbone on (TPU.INT8_SCORING, "
                    "and TPU.INT8_SCORING_FORCE outside its gates)")
            self.model_type = engine.model_type
            self.num_layers = engine.cfg.POSE_ESTIMATOR.NUM_LAYERS
            self.int8_head = engine.int8_head
            self.float_tail = engine.int8_float_tail
            if self.model_type == "HRNET":
                self.stage_configs = engine.model.stage_configs
                self.final_conv_kernel = engine.model.final_conv_kernel
            self.qp = _Tensors(_int8_weights_read(engine._int8_weights, self.model_type,
                                                  self.int8_head, self.float_tail))
            self.scales = _Tensors({k: torch.as_tensor(v, dtype=torch.float32, device=engine.device)
                                    for k, v in int8_scales.items()})
            self.model = None
        else:
            self.model = copy.deepcopy(engine.model).eval().requires_grad_(False)
            self.k3_heads = None
            if engine.use_pallas_head:
                self.k3_heads = nn.ModuleList(_Tensors(op._asdict()) for op in engine._k3_heads)

    def _heatmaps(self, flat: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC crops -> float32 NCHW heatmaps."""
        if self.use_int8:
            from .models import quantize

            qp, scales = self.qp.table(), self.scales.table()
            if self.model_type == "HRNET":
                return quantize.quantized_hrnet_forward(
                    qp, flat, *self.stage_configs, self.final_conv_kernel, act_scales=scales)
            return quantize.quantized_pose_resnet_forward(
                qp, flat, self.num_layers, act_scales=scales, int8_head=self.int8_head,
                float_tail_stages=self.float_tail)
        x = flat.permute(0, 3, 1, 2).contiguous()
        if self.k3_heads is not None:
            heads = [kernels.deconv.K3Operands(**t.table()) for t in self.k3_heads]
            return kernels.deconv.apply_pose_resnet_head(self.model(x, skip_head=True),
                                                         self.model, heads)
        return self.model(x)

    def forward(self, images: torch.Tensor, square_box: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, V = images.shape[0], images.shape[1]
        flat = images.reshape((B * V,) + tuple(images.shape[2:]))
        mean, std = self.mean, self.std
        if self.s2d_stem and flat.shape[1] % 2 == 0 and flat.shape[2] % 2 == 0:
            flat = space_to_depth(flat)
            mean, std = mean.repeat(4), std.repeat(4)
        flat = (flat.to(self.dtype) / 255.0 - mean) / std
        hm = self._heatmaps(flat)
        hm = hm.reshape((B, V) + tuple(hm.shape[1:])).to(torch.float32)  # [B, V, K, h, w]
        keypoints, confidence = heatmap_ops.decode_keypoints_bbox(hm, square_box, with_peak=True)
        return {
            "heatmaps": hm.permute(0, 1, 3, 4, 2).contiguous(),
            "keypoints": keypoints,
            "confidence": confidence,
        }


def build_serve_fn(engine, state=None, int8_scales=None) -> ServeModule:
    """The serve function of `engine` on `state`'s weights (an
    ``engine.TrainState`` or a reference-named float32 state dict; None
    keeps the engine's), frozen: later training does not reach it.

    With `int8_scales` (``engine.int8_calibrate``'s table, or the JAX
    package's through ``models.convert.scales_from_jax``) the backbone runs
    int8 with those static scales; the engine's config must turn the int8
    path on."""
    if state is not None:
        if isinstance(state, Mapping):
            engine.load_state_dict(state)
        else:
            engine.use_state(state)
    return ServeModule(engine, int8_scales).to(engine.device).eval()


def _example(engine, batch: int, num_views: int):
    cfg = engine.cfg
    H, W = cfg.DATA.INPUT_HEIGHT, cfg.DATA.INPUT_WIDTH
    images = torch.zeros((batch, num_views, H, W, 3), dtype=torch.uint8, device=engine.device)
    box = torch.zeros((batch, num_views, 4), dtype=torch.float32, device=engine.device)
    box[..., 2], box[..., 3] = W, H
    return images, box


def export_serving(engine, state, batch_size: Optional[int], num_views: int,
                   int8_scales=None) -> torch.export.ExportedProgram:
    """Trace the serve function into a ``torch.export.ExportedProgram`` on
    the engine's device.

    ``batch_size=None`` exports a symbolic batch dimension ``b`` (one
    artifact, any request size; traced at two frames); views, image size
    and joints stay static, as in the JAX package."""
    module = build_serve_fn(engine, state, int8_scales)
    if batch_size is None:
        b = torch.export.Dim("b", min=1)
        example = _example(engine, 2, num_views)
        dynamic = {"images": {0: b}, "square_box": {0: b}}
    else:
        example = _example(engine, batch_size, num_views)
        dynamic = None
    ep = torch.export.export(module, example, dynamic_shapes=dynamic, strict=False)
    ep.example_inputs = None  # the artifact would carry the example frames (12 MB a frame)
    ep._mval_meta = {
        "batch": "b" if batch_size is None else int(batch_size),
        "views": int(num_views),
        "input_hw": [int(engine.cfg.DATA.INPUT_HEIGHT), int(engine.cfg.DATA.INPUT_WIDTH)],
        "joints": int(engine.cfg.DATA.NUM_JOINTS),
        "model": engine.model_type,
        "compute_dtype": str(engine.dtype).replace("torch.", ""),
        "int8": int8_scales is not None,
        "device": engine.device.type,
        "torch": torch.__version__,
    }
    return ep


def input_shapes(ep: torch.export.ExportedProgram):
    """The shapes of the artifact's two inputs, with ``"b"``-like names for
    symbolic dimensions."""
    names = set(ep.graph_signature.user_inputs)
    return [tuple(d if isinstance(d, int) else str(d) for d in n.meta["val"].shape)
            for n in ep.graph.nodes if n.op == "placeholder" and n.name in names]


def save_serving(ep: torch.export.ExportedProgram, path: str) -> str:
    """Write the artifact (``SERVING_SUFFIX``) with its description and log
    its size."""
    meta = getattr(ep, "_mval_meta", {})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path, extra_files={META_FILE: json.dumps(meta)})
    _logger.info("Serving artifact: %s (%.1f MB, %s)"
                 % (path, os.path.getsize(path) / 1e6, meta))
    return path


def load_serving(path: str, device: Optional[Union[str, torch.device]] = None):
    """Read an artifact -> callable(images, square_box) returning the
    contract's dict on `device` (the card unless "cpu" is asked for).

    Needs torch and the kernels' operator registrations (imported with this
    module), not the config, the engine, the models or a checkpoint.
    ``call.exported`` is the ExportedProgram, ``call.meta`` its
    description, ``call.device`` where it runs."""
    device = resolve_device(device)
    extra = {META_FILE: ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META_FILE] or "{}")
    if meta.get("torch") not in (None, torch.__version__):
        _logger.warning("%s was written by torch %s; this is torch %s"
                        % (path, meta["torch"], torch.__version__))
    if meta.get("device") != device.type:
        raise ValueError("%s was exported on %s; load it there (asked for %s)"
                         % (path, meta.get("device"), device))
    module = ep.module()

    def call(images, square_box) -> Dict[str, torch.Tensor]:
        images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        square_box = torch.as_tensor(square_box, dtype=torch.float32)
        return module(images.to(device), square_box.to(device))

    call.exported = ep
    call.meta = meta
    call.device = device
    return call
