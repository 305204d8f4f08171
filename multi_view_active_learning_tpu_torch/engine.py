"""Scoring / eval engine of the port: the active-learning scoring pass.

Port of the JAX package's engine.py for the inference steps (reference:
strategy.py:173-187, 584-634 and 1004-1215): uint8 multi-view frames ->
ImageNet normalization in the compute dtype -> PoseResNet or HRNet forward
-> fused heatmap decode (K1) -> RANSAC-DLT triangulation (with the Huber
refine under ``AL.DIRECT_OPTIMIZATION``) -> AL metric (TRIANGULATION,
MPE / HP / BSB with AVG or STD, RANDOM, or none for CORESET, which with
``AL.CORESET_FEATURES=EMBEDDING`` returns the pooled trunk embedding).

The forward is routed as the JAX engine routes it: the int8 backbone
(models/quantize.py; ``TPU.INT8_SCORING``, on by default, gated per
strategy and, for HRNet, by ``TPU.INT8_SCORING_HRNET``; PoseResNet's head
through K4 under ``TPU.INT8_DECONV``), else the float trunk with the head
through K3 (``TPU.PALLAS_HEAD``, PoseResNet), else the standard float
model.  The EMBEDDING features and ``loss_step`` always take the float
model.

The engine owns the model and its weights (``load_state_dict``), runs on
the CUDA device unless given ``device="cpu"``, and raises
``NotImplementedError`` for every config option this port does not
implement yet instead of ignoring it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from .device import resolve_device, to_device
from .kernels import deconv
from .models import build_model, compute_dtype
from .models import quantize
from .ops import geometry
from .ops import triangulate as tri
from .ops import uncertainty
from .utils import prng

# (config key, value that is not ported, ROADMAP queue item)
_UNPORTED = (
    ("TPU.SPACE_TO_DEPTH_STEM", True, "Queue A12, exact reformulation options"),
    ("TPU.FAST_DECONV", True, "Queue A12, exact reformulation options"),
)

SCORING_STRATEGIES = ("TRIANGULATION", "RANDOM", "CORESET", "MPE", "HP", "BSB")

# Strategies whose selection measured int8-safe in the JAX package
# (tools/validate_learning.py --int8_compare, BENCH_NOTES round 4): they
# consume argmax locations or triangulated geometry.  MPE and BSB rank raw
# heatmap values, which requantization perturbs, so they score float.
INT8_SAFE_STRATEGIES = ("TRIANGULATION", "HP", "CORESET", "RANDOM")

# {strategy: minimum float tail stages} for strategies measured safe only
# with a bf16 tail; empty, as in the JAX package.
INT8_MIXED_TAIL: Dict[str, int] = {}


def _get(cfg, dotted: str):
    node = cfg
    for part in dotted.split("."):
        node = getattr(node, part)
    return node


def check_ported(cfg) -> None:
    """Raise NotImplementedError naming the key and the ROADMAP item for
    each option this port does not implement yet."""
    for key, value, item in _UNPORTED:
        if _get(cfg, key) == value:
            raise NotImplementedError(
                "%s=%r is not ported to PyTorch yet (ROADMAP %s)" % (key, value, item)
            )
    if cfg.TPU.VIEW_AXIS != 1:
        raise NotImplementedError(
            "TPU.VIEW_AXIS=%r is not ported to PyTorch yet (ROADMAP Queue A9, "
            "multi-GPU)" % cfg.TPU.VIEW_AXIS
        )
    if cfg.TPU.HRNET_PACKED_MAX_CH > 0:
        raise NotImplementedError(
            "TPU.HRNET_PACKED_MAX_CH=%r is not ported to PyTorch yet (ROADMAP Queue A12, "
            "exact reformulation options)" % cfg.TPU.HRNET_PACKED_MAX_CH
        )


def _int8_supported(cfg) -> bool:
    """PoseResNet scores int8 by default; HRNet only with
    TPU.INT8_SCORING_HRNET (int8 measured a net loss there on the TPU)."""
    if cfg.POSE_ESTIMATOR.TYPE == "POSE_RESNET":
        return True
    return cfg.POSE_ESTIMATOR.TYPE == "HRNET" and bool(cfg.TPU.INT8_SCORING_HRNET)


def use_int8(cfg) -> bool:
    """Int8 backbone for the scoring path: TPU.INT8_SCORING, gated to the
    int8-safe strategies (or those with a mixed float tail).
    TPU.INT8_SCORING_FORCE overrides every gate.  CORESET with EMBEDDING
    features reports False unless forced: its scoring runs the float
    features forward regardless."""
    if (cfg.AL.STRATEGY == "CORESET" and cfg.AL.CORESET_FEATURES == "EMBEDDING"
            and not cfg.TPU.INT8_SCORING_FORCE):
        return False
    return (
        bool(cfg.TPU.INT8_SCORING)
        and _int8_supported(cfg)
        and (cfg.AL.STRATEGY in INT8_SAFE_STRATEGIES
             or cfg.AL.STRATEGY in INT8_MIXED_TAIL
             or bool(cfg.TPU.INT8_SCORING_FORCE))
    )


def use_int8_eval(cfg) -> bool:
    """Int8 backbone for the eval path (TPU.INT8_EVAL, off by default)."""
    return bool(cfg.TPU.INT8_EVAL) and _int8_supported(cfg)


def int8_float_tail(cfg) -> int:
    """TPU.INT8_FLOAT_TAIL_STAGES, raised to the measured-safe minimum of
    strategies in INT8_MIXED_TAIL unless TPU.INT8_SCORING_FORCE is set."""
    tail = int(cfg.TPU.INT8_FLOAT_TAIL_STAGES)
    if not cfg.TPU.INT8_SCORING_FORCE and cfg.AL.STRATEGY in INT8_MIXED_TAIL:
        tail = max(tail, INT8_MIXED_TAIL[cfg.AL.STRATEGY])
    return tail


class Engine:
    """Owns the model and the scoring / eval steps."""

    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        self.model = build_model(cfg).to(self.device).eval()
        self.model_type = cfg.POSE_ESTIMATOR.TYPE
        self.stride = cfg.POSE_ESTIMATOR.STRIDE
        self.use_int8 = use_int8(cfg)
        self.use_int8_eval = use_int8_eval(cfg)
        self.int8_float_tail = int8_float_tail(cfg)
        # The port always runs its own kernels, so the heads follow the
        # options alone (the JAX engine also needs a Pallas backend), and
        # TPU.USE_PALLAS=False decodes through K1 all the same: the JAX
        # package's XLA decode gives the kernel's values.
        self.int8_head = bool(cfg.TPU.INT8_DECONV)
        self.use_pallas_head = bool(cfg.TPU.PALLAS_HEAD) and self.model_type == "POSE_RESNET"
        self._pairs_cache: Dict[int, np.ndarray] = {}
        self._mean = torch.as_tensor(geometry.IMAGENET_MEAN, device=self.device).to(self.dtype)
        self._std = torch.as_tensor(geometry.IMAGENET_STD, device=self.device).to(self.dtype)
        self._int8_weights: Optional[Dict[str, torch.Tensor]] = None
        self._k3_heads: Optional[List[deconv.K3Operands]] = None
        self._prepare_weights(self.model.state_dict())

    def load_state_dict(self, state_dict) -> None:
        """Load reference-named weights (e.g. ``convert.from_flax``'s output),
        strictly; float32 tensors are cast to the compute dtype.  When an
        int8 path is on, the given (float32) weights are also quantized, as
        the JAX package quantizes its float32 parameters.  The heads' kernel
        operands are packed here, once per load."""
        self.model.load_state_dict(state_dict, strict=True)
        self._prepare_weights(state_dict)

    def _prepare_weights(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        if self.use_pallas_head:
            self._k3_heads = deconv.pack_pose_resnet_head(self.model, self.dtype)
        if self.use_int8 or self.use_int8_eval:
            self._int8_weights = quantize.quantize_state_dict(
                {k: v.to(self.device) for k, v in state_dict.items()},
                self.cfg.POSE_ESTIMATOR.NUM_LAYERS, int8_head=self.int8_head,
                model_type=self.model_type,
            )

    def pairs(self, num_views: int) -> np.ndarray:
        if num_views not in self._pairs_cache:
            self._pairs_cache[num_views] = tri.all_view_pairs(
                num_views,
                n_iters=self.cfg.AL.RANSAC_N_ITERS,
                seed=int(self.cfg.RANDOM_SEED) & 0x7FFFFFFF,
            )
        return self._pairs_cache[num_views]

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _flatten_normalize(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 [B, V, H, W, 3] -> normalized NHWC [B*V, H, W, 3] in the
        compute dtype; float inputs are taken as already normalized."""
        B, V = images.shape[0], images.shape[1]
        flat = images.reshape((B * V,) + tuple(images.shape[2:]))
        if flat.dtype == torch.uint8:
            flat = (flat.to(self.dtype) / 255.0 - self._mean) / self._std
        return flat

    def _int8_forward(self, flat: torch.Tensor, act_scales=None, collect_scales=False):
        if self._int8_weights is None:
            raise RuntimeError("the int8 backbone is off in this engine's config")
        if self.model_type == "HRNET":
            return quantize.quantized_hrnet_forward(
                self._int8_weights, flat, *self.model.stage_configs,
                self.model.final_conv_kernel, act_scales=act_scales,
                collect_scales=collect_scales,
            )
        return quantize.quantized_pose_resnet_forward(
            self._int8_weights, flat, self.cfg.POSE_ESTIMATOR.NUM_LAYERS,
            act_scales=act_scales, collect_scales=collect_scales,
            int8_head=self.int8_head, float_tail_stages=self.int8_float_tail,
        )

    @torch.inference_mode()
    def int8_calibrate(self, images, for_eval: bool = False) -> Optional[Dict[str, torch.Tensor]]:
        """One-batch activation-scale calibration for static int8 inference.
        Returns the scale table to pass back as ``int8_scales``, or None when
        the int8 path (scoring, or eval with ``for_eval``) is off, so callers
        can pass the result through unconditionally."""
        if not (self.use_int8_eval if for_eval else self.use_int8):
            return None
        _, scales = self._int8_forward(
            self._flatten_normalize(self._tensor(images)), collect_scales=True)
        return scales

    @torch.inference_mode()
    def forward(self, images, int8_scales: Optional[Mapping[str, torch.Tensor]] = None,
                use_int8: Optional[bool] = None) -> torch.Tensor:
        """Inference heatmaps: [B, V, H, W, 3] -> float32 [B, V, K, h, w].

        ``use_int8`` selects the int8 backbone (None: the scoring default,
        ``self.use_int8``); ``int8_scales`` is a static scale table from
        ``int8_calibrate`` (None: dynamic scales)."""
        images = self._tensor(images)
        B, V = images.shape[0], images.shape[1]
        flat = self._flatten_normalize(images)
        if self.use_int8 if use_int8 is None else use_int8:
            out = self._int8_forward(flat, act_scales=int8_scales)
        else:
            x = flat.permute(0, 3, 1, 2).contiguous()
            if self.use_pallas_head:
                out = deconv.apply_pose_resnet_head(self.model(x, skip_head=True), self.model,
                                                    self._k3_heads)
            else:
                out = self.model(x)
        return out.reshape((B, V) + tuple(out.shape[1:]))

    @torch.inference_mode()
    def score_step(
        self,
        images,
        proj_matrices,
        joint_valid,
        pairs,
        gt_keypoints_3d,
        al_strategy: str = "TRIANGULATION",
        key: Optional[np.ndarray] = None,
        int8_scales: Optional[Mapping[str, torch.Tensor]] = None,
        mpe_aggregate: str = "AVG",
        hp_aggregate: str = "AVG",
        bsb_aggregate: str = "AVG",
    ) -> Dict[str, torch.Tensor]:
        """Unlabeled-pool scoring: forward + triangulation + AL metric.

        images: uint8 [B, V, H, W, 3]; proj_matrices: [B, V, 3, 4];
        joint_valid: [B, K] bool; pairs: [P, 2]; gt_keypoints_3d: [B, K, 3].
        RANDOM draws ``jax.random.uniform(key, (B,))``'s bits from `key`, a
        threefry key of ``utils.prng`` (padded rows draw too); MPE / HP / BSB aggregate over the valid
        (view, joint) entries by their `*_aggregate` ("AVG" or "STD").  The
        forward is int8 when ``use_int8``, with the static ``int8_scales`` of
        ``int8_calibrate`` if given.  Returns keypoints_3d [B, K, 3],
        sal_metric [B], inlier_count [B], al_metric [B] and mkpe [B], plus
        embedding [B, C] (the view-averaged pooled trunk features) for
        CORESET with AL.CORESET_FEATURES=EMBEDDING.
        """
        if al_strategy not in SCORING_STRATEGIES:
            raise NotImplementedError("Unknown AL strategy: %s" % al_strategy)
        if al_strategy == "RANDOM" and key is None:
            raise ValueError("the RANDOM strategy needs a PRNG key (utils.prng.PRNGKey)")
        embedding = None
        if al_strategy == "CORESET" and self.cfg.AL.CORESET_FEATURES == "EMBEDDING":
            heatmaps, embedding = self._features_forward(images)
        else:
            heatmaps = self.forward(images, int8_scales, use_int8=self.use_int8)
        joint_valid = self._tensor(joint_valid, torch.bool)
        res = tri.triangulate_frames(
            heatmaps,
            self._tensor(proj_matrices, torch.float32),
            joint_valid,
            self._tensor(pairs, torch.int64),
            stride=self.stride,
            use_soft_argmax=self.cfg.AL.USE_SOFTARGMAX,
            use_reprojection_xe=self.cfg.AL.USE_REPROJECTION_XE,
            sigma=self.cfg.AL.REPROJECTION_SIGMA,
            epsilon=self.cfg.AL.RANSAC_EPSILON,
            method=self.cfg.TPU.DLT_METHOD,
            confidence_weighted=self.cfg.AL.CONFIDENCE_WEIGHTED_DLT,
            direct_optimization=self.cfg.AL.DIRECT_OPTIMIZATION,
        )
        B = heatmaps.shape[0]
        if al_strategy == "RANDOM":
            al_metric = to_device(prng.uniform(key, (B,)), self.device)
        elif al_strategy == "TRIANGULATION":
            al_metric = res["metric"]
        elif al_strategy == "MPE":
            al_metric = uncertainty.multi_peak_entropy(heatmaps, joint_valid, mpe_aggregate)
        elif al_strategy == "HP":
            al_metric = uncertainty.highest_probability(heatmaps, joint_valid, hp_aggregate)
        elif al_strategy == "BSB":
            al_metric = uncertainty.best_vs_second_best(heatmaps, joint_valid, bsb_aggregate)
        else:  # CORESET ranks poses or embeddings afterwards; no per-frame metric
            al_metric = torch.zeros((B,), device=self.device)

        # Per-frame MKPE against GT (strategy.py:1134-1145).
        d = torch.square(res["keypoints_3d"] - self._tensor(gt_keypoints_3d, torch.float32))
        d = torch.where(joint_valid[..., None], d, torch.zeros_like(d))
        d = torch.sqrt(torch.sum(d, dim=-1))  # [B, K]
        count = torch.clamp(torch.sum(joint_valid, dim=-1), min=1)
        mkpe = torch.sum(d, dim=-1) / count

        out = {
            "keypoints_3d": res["keypoints_3d"],
            "sal_metric": res["metric"],
            "inlier_count": res["inlier_count"],
            "al_metric": al_metric,
            "mkpe": mkpe,
        }
        if embedding is not None:
            out["embedding"] = embedding
        return out

    def _features_forward(self, images):
        """The standard float forward with the pooled trunk features:
        (heatmaps [B, V, K, h, w], view-averaged embedding [B, C] float32),
        shared by score_step and embed_step so the pool's and the labeled
        set's embeddings come from one function.  Never int8 and never K3,
        whatever TPU.INT8_SCORING_FORCE or PALLAS_HEAD say (JAX
        engine.py:550-567): k-center distances on requantized features buy
        noise, not speed."""
        images = self._tensor(images)
        B, V = images.shape[0], images.shape[1]
        x = self._flatten_normalize(images).permute(0, 3, 1, 2).contiguous()
        out, feats = self.model(x, return_features=True)
        heatmaps = out.reshape((B, V) + tuple(out.shape[1:]))
        return heatmaps, torch.mean(feats.reshape(B, V, -1), dim=1)

    @torch.inference_mode()
    def embed_step(self, images) -> torch.Tensor:
        """Pooled trunk embeddings [B, V, H, W, 3] -> [B, C] float32: the
        AL.CORESET_FEATURES=EMBEDDING features of frames the scoring sweep
        does not visit (the labeled set)."""
        return self._features_forward(images)[1]

    @torch.inference_mode()
    def loss_step(self, images, gt_heatmaps) -> torch.Tensor:
        """Per-frame heatmap MSE for CLUSTER TYPE=LOSS (reference:
        strategy.py:173-187): sum((heatmaps - gt)^2) / (h * w) per frame,
        [B].  gt_heatmaps in the port's layout [B, V, K, h, w].  Always the
        float forward."""
        heatmaps = self.forward(images, use_int8=False)
        sq = torch.square(heatmaps - self._tensor(gt_heatmaps, torch.float32))
        h, w = heatmaps.shape[-2], heatmaps.shape[-1]
        return torch.sum(sq, dim=(1, 2, 3, 4)) / (h * w)

    @torch.inference_mode()
    def eval_step(self, images, proj_matrices, joint_valid, pairs,
                  int8_scales: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Validation triangulation.  Float unless TPU.INT8_EVAL opts eval
        into the int8 backbone.  Decodes by hard argmax whatever
        AL.USE_SOFTARGMAX / USE_REPROJECTION_XE say, as the reference's eval
        loop does (reference strategy.py:607-612)."""
        heatmaps = self.forward(images, int8_scales, use_int8=self.use_int8_eval)
        res = tri.triangulate_frames(
            heatmaps,
            self._tensor(proj_matrices, torch.float32),
            self._tensor(joint_valid, torch.bool),
            self._tensor(pairs, torch.int64),
            stride=self.stride,
            epsilon=self.cfg.AL.RANSAC_EPSILON,
            method=self.cfg.TPU.DLT_METHOD,
            confidence_weighted=self.cfg.AL.CONFIDENCE_WEIGHTED_DLT,
        )
        return {"keypoints_3d": res["keypoints_3d"]}
