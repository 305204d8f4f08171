"""Engine of the port: the active-learning scoring pass and training.

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

Training (JAX engine.py:49-226): ``init_state`` / ``state_from_state_dict``
make a ``TrainState`` (float32 master weights, BN running statistics,
Adam's moments and count, the step), and ``train_step`` runs one
optimizer step on it: the float model in train mode (bf16 compute under
the default TPU.COMPUTE_DTYPE, BN statistics folded in as flax does,
TPU.REMAT rematerializing blocks), the masked heatmap MSE and / or the
integral loss normalized by the real crops, bare Adam with the staircase
LR taken from the always-advancing step, and the step-skip (non-finite or
clipped loss, or no real crop) selected on the device, so a step never
waits on the host.

Under a process group (``parallel``; one process a card) the engine
computes what the JAX engine computes on the global batch of a ``('data',
'view')`` mesh, each rank holding its data row's frames and, when the view
axis divides a frame's views, its block of them (``parallel.view_slice``;
the camera arrays, ``proj_matrices`` and ``per_view_joint_valid``, always
hold every view, and give the engine the frame's view count): BatchNorm's
train-mode statistics over the global batch (models/layers.py), the losses
over the global count of real crops and valid joints, one all-reduce (a
sum) of the flat gradient with the loss, so the step-skip and the update
are the same bits on every rank, all three over ``parallel.batch_group``
(every rank when views shard, else the data group); the triangulation's
keypoints, the per-view uncertainty values and the EMBEDDING view sum
gathered within the view group; int8 calibration's activation maxima over
all ranks; RANDOM's draws for the global batch, of which each rank keeps
its data row's.

The exact reformulation options (JAX models/pose_resnet.py, ops/
packed_conv.py) change how a layer computes, never what: under
``TPU.SPACE_TO_DEPTH_STEM`` PoseResNet's uint8 frames are space-to-depth'd
before normalization and the stem runs as a dense 4x4 conv (float or
int8); ``TPU.FAST_DECONV`` computes the float head's transposed convs as
``PhaseDeconv``; ``TPU.HRNET_PACKED_MAX_CH`` packs HRNet's narrow branch
convs (``PackedConv2d``).  The int8 head (K4) and the K3 head take
precedence over FAST_DECONV where they are on, as in JAX.

The engine owns the model and its inference weights (``load_state_dict``,
or ``use_state`` for a TrainState, which refreshes them, the int8 weights
and the K3 packs only when the state has changed) and runs on the CUDA
device unless given ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from . import parallel
from .device import resolve_device, to_device
from .kernels import deconv
from .models import build_model, compute_dtype
from .models import quantize
from .models.layers import batch_norms
from .ops import geometry
from .ops import heatmap as heatmap_ops
from .ops.image import space_to_depth
from .ops import triangulate as tri
from .ops import uncertainty
from .utils import prng

SCORING_STRATEGIES = ("TRIANGULATION", "RANDOM", "CORESET", "MPE", "HP", "BSB")

# Strategies whose selection measured int8-safe in the JAX package
# (tools/validate_learning.py --int8_compare, BENCH_NOTES round 4): they
# consume argmax locations or triangulated geometry.  MPE and BSB rank raw
# heatmap values, which requantization perturbs, so they score float.
INT8_SAFE_STRATEGIES = ("TRIANGULATION", "HP", "CORESET", "RANDOM")

# {strategy: minimum float tail stages} for strategies measured safe only
# with a bf16 tail; empty, as in the JAX package.
INT8_MIXED_TAIL: Dict[str, int] = {}


def check_ported(cfg) -> None:
    """Check the config's mesh against the process group, as JAX's make_mesh
    does (ValueError), and make it the run's layout (``parallel.use_mesh``).
    Every option of the JAX package's config is ported."""
    parallel.mesh_from_config(cfg)


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


TRAIN_LOSSES = ("MSE", "INTEGRAL", "MSE+INTEGRAL")

# optax.scale_by_adam's defaults (JAX engine.py:83), and flax BatchNorm's
# running-average decay (momentum 0.9, JAX models/pose_resnet.py:41-50).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BN_DECAY = 0.9


def make_lr_schedule(cfg) -> Callable:
    """StepLR as optax's staircase exponential decay (JAX engine.py:49-57):
    ``LR * RATE ** floor(step / STEP_SIZE)``.  Takes an int or an integer
    tensor; returns a float32 tensor on the step's device."""
    lr0 = float(cfg.TRAIN.OPTIM.LR)
    rate = float(cfg.TRAIN.OPTIM.LR_DECAY_RATE)
    size = int(cfg.TRAIN.OPTIM.LR_DECAY_STEP_SIZE)

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step)
        p = torch.floor(step.to(torch.float32) / size)
        lr = lr0 * torch.pow(rate, p)  # a Python base: no upload to the card
        return torch.where(step <= 0, torch.full_like(lr, lr0), lr)

    return schedule


def _flat(tensors: Mapping[str, torch.Tensor], device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One float32 buffer on `device` holding `tensors` in order, and a view
    of it for each name."""
    parts = [torch.as_tensor(t).detach().reshape(-1).to(torch.float32) for t in tensors.values()]
    if len({t.device for t in parts}) > 1:
        parts = [t.to(device) for t in parts]
    # One copy between devices, after the concatenation on the source.
    flat = (torch.cat(parts) if parts else torch.zeros(0)).to(device)
    views, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel()
        views[name] = flat[offset:offset + n].view(tuple(t.shape))
        offset += n
    return flat, views


class TrainState:
    """The training state, on one device: `step` (int64, drives the LR and
    advances on skipped steps too), `params` (float32 master weights) and
    `buffers` (BN running means and variances) under the reference's names,
    and Adam's `mu`, `nu` and `count` (the JAX TrainState's step, params,
    batch_stats and opt_state).

    Params, moments and statistics are views into one flat float32 buffer
    each (`flat`), so the optimizer and the step-skip run as a few
    whole-buffer kernels.  ``Engine.train_step`` updates the tensors in
    place, as the JAX step donates its state, and bumps `version`, by which
    the engine knows its inference weights are stale."""

    def __init__(self, params: Mapping[str, torch.Tensor], buffers: Mapping[str, torch.Tensor],
                 device, step=0, mu: Optional[Mapping] = None, nu: Optional[Mapping] = None,
                 count=0):
        device = torch.device(device)
        self.flat: Dict[str, torch.Tensor] = {}
        self.flat["params"], self.params = _flat(params, device)
        self.flat["buffers"], self.buffers = _flat(buffers, device)
        if mu is None:
            mu = {k: torch.zeros(v.shape) for k, v in params.items()}
        if nu is None:
            nu = {k: torch.zeros(v.shape) for k, v in params.items()}
        self.flat["mu"], self.mu = _flat({k: mu[k] for k in params}, device)
        self.flat["nu"], self.nu = _flat({k: nu[k] for k in params}, device)
        # Own copies: a state must not share its counters with its source.
        self.step = torch.tensor(int(step), dtype=torch.int64, device=device)
        self.count = torch.tensor(int(count), dtype=torch.int64, device=device)
        self.version = 0

    @property
    def device(self) -> torch.device:
        return self.step.device

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's weights and BN statistics under reference names
        (views: clone before keeping them across a train step)."""
        return {**self.params, **self.buffers}

    def clone_to(self, device) -> "TrainState":
        """A copy on `device` (one copy a flat buffer)."""
        return TrainState(self.params, self.buffers, device, self.step, self.mu, self.nu,
                          self.count)

    def clone(self) -> "TrainState":
        return self.clone_to(self.device)


def _init_std(model_type: str, name: str) -> Optional[float]:
    """The flax initializer of a conv weight (JAX models/pose_resnet.py,
    models/hrnet.py): None for lecun_normal (the residual blocks' convs, and
    PoseResNet's stem), else the normal(0, 0.001) std of PoseResNet's
    deconvs and final layer and of HRNet's stem, transition, fuse and final
    convs."""
    if model_type == "HRNET":
        in_blocks = name.startswith("layer1.") or ".branches." in name
        return None if in_blocks else 0.001
    return 0.001 if name.startswith(("deconv_layers.", "final_layer.")) else None


class Engine:
    """Owns the model, the scoring / eval steps and the training step."""

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
        # Training: the trainable names in the reference's order (Adam's
        # parameter order), the BN statistics flax keeps, the schedule, and
        # the TrainState whose weights the inference model holds.
        self.model.remat = bool(cfg.TPU.REMAT)
        self.param_names = [n for n, _ in self.model.named_parameters()]
        self._bns = batch_norms(self.model)
        self.buffer_names = [n + suffix for n, _ in self._bns
                             for suffix in (".running_mean", ".running_var")]
        self.lr_schedule = make_lr_schedule(cfg)
        self._used_state: Optional[TrainState] = None
        self._used_version = -1

    def load_state_dict(self, state_dict) -> None:
        """Load reference-named weights (e.g. ``convert.from_flax``'s output),
        strictly; float32 tensors are cast to the compute dtype.  When an
        int8 path is on, the given (float32) weights are also quantized, as
        the JAX package quantizes its float32 parameters.  The heads' kernel
        operands are packed here, once per load."""
        self.model.load_state_dict(state_dict, strict=True)
        self._prepare_weights(state_dict)
        self._used_state = None

    def use_state(self, state: TrainState) -> None:
        """Make the inference model hold `state`'s weights: its compute-dtype
        copy of the master weights and BN statistics, the int8 weights and
        the K3 packs, refreshed only when `state` is another state or has
        trained since (its `version`)."""
        if state is self._used_state and state.version == self._used_version:
            return
        with torch.no_grad():
            params = dict(self.model.named_parameters())
            buffers = dict(self.model.named_buffers())
            names = list(state.params)
            torch._foreach_copy_([params[n] for n in names], [state.params[n] for n in names])
            names = list(state.buffers)
            torch._foreach_copy_([buffers[n] for n in names], [state.buffers[n] for n in names])
        self._prepare_weights(state.state_dict())
        self._used_state, self._used_version = state, state.version

    # -- training -------------------------------------------------------------

    def state_from_state_dict(self, state_dict: Mapping[str, torch.Tensor], step=0) -> TrainState:
        """A TrainState with these reference-named weights and statistics and
        a fresh optimizer (``convert.from_flax``'s output, or a checkpoint's
        ``state_dict``)."""
        return TrainState({n: state_dict[n] for n in self.param_names},
                          {n: state_dict[n] for n in self.buffer_names}, self.device, step)

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh TrainState drawn as flax initializes the JAX models:
        lecun_normal (truncated at two standard deviations, fan-in scaled)
        or normal(0, 0.001) conv weights (`_init_std`), zero biases, BN scale
        1 and bias 0, running mean 0 and variance 1.  Drawn on the CPU from
        `generator` in parameter order, so a seed gives the same weights on
        any device."""
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        params = {}
        for name, p in self.model.named_parameters():
            t = torch.zeros(p.shape, dtype=torch.float32)
            if name.endswith(".bias"):
                pass
            elif p.dim() == 1:  # BN scale
                t.fill_(1.0)
            elif _init_std(self.model_type, name) is not None:
                t.normal_(0.0, _init_std(self.model_type, name), generator=generator)
            else:
                # Conv2d weight [O, I, kh, kw] (ConvTranspose2d only takes
                # the normal init): flax's fan-in is I * kh * kw.
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                            generator=generator)
            params[name] = t
        buffers = {n: (torch.ones if n.endswith("running_var") else torch.zeros)(
            dict(self.model.named_buffers())[n].shape) for n in self.buffer_names}
        return TrainState(params, buffers, self.device)

    def _bound_model(self, tensors: Mapping[str, torch.Tensor], group=None):
        """Context: the model's parameters replaced by `tensors` (same names)
        in train mode, its BatchNorms' statistics taken over `group`'s rows
        (``parallel.batch_group``), restored on exit.  The backward pass runs
        inside, so a rematerialized forward (TPU.REMAT) also sees the bound
        tensors."""
        import contextlib

        @contextlib.contextmanager
        def bound():
            saved = []
            for name, t in tensors.items():
                prefix, _, leaf = name.rpartition(".")
                module = self.model.get_submodule(prefix)
                saved.append((module, leaf, module._parameters[leaf]))
                module._parameters[leaf] = t
            for _, bn in self._bns:
                bn.batch_stats, bn.group = None, group
            self.model.train()
            try:
                yield
            finally:
                self.model.eval()
                for module, leaf, p in saved:
                    module._parameters[leaf] = p

        return bound()

    def _loss_and_grads(self, state: TrainState, images, gt_heatmaps, per_view_joint_valid,
                        frame_valid):
        """The train-mode forward and backward on `state`'s weights:
        (this rank's share of the loss, its gradients in parameter order,
        the first crop's heatmap [K, h, w], the global batch's real crop
        count, the group the batch's sums run over).  Each BatchNorm keeps
        its batch statistics in its record."""
        loss_type = self.cfg.TRAIN.LOSS
        if loss_type not in TRAIN_LOSSES:
            raise NotImplementedError("Unknown TRAIN.LOSS: %s" % loss_type)
        images = self._tensor(images, torch.float32)
        per_view_joint_valid = self._tensor(per_view_joint_valid, torch.bool)
        views = self._views(images, per_view_joint_valid.shape[1])
        group = parallel.batch_group(per_view_joint_valid.shape[1])
        B, V = images.shape[0], images.shape[1]
        x = images.reshape((B * V,) + tuple(images.shape[2:])).permute(0, 3, 1, 2).contiguous()
        gt = self._tensor(gt_heatmaps, torch.float32)
        gt = gt.reshape((B * V,) + tuple(gt.shape[2:]))
        frame_valid = self._tensor(frame_valid, torch.bool)
        mask = (per_view_joint_valid[:, views]
                & frame_valid[:, None, None]).reshape(B * V, -1, 1, 1)
        # The loss counts REAL crops only (JAX engine.py:161-166): padding
        # rows in the denominator would dilute a tail batch's gradient.  The
        # denominators count the global batch (JAX's sum runs over the
        # sharded batch), so each rank's loss is its share of the global
        # loss and the ranks' gradients sum to the global loss's.
        integral = loss_type in ("INTEGRAL", "MSE+INTEGRAL")
        counts = [torch.sum(frame_valid.to(torch.float32)) * V]
        if integral:
            counts.append(torch.sum(heatmap_ops.integral_valid(gt, mask[:, :, 0, 0]))
                          .to(torch.float32))
        counts = parallel.all_reduce_sum(torch.stack(counts), group)
        n_valid_crops = counts[0]

        leaves = {n: state.params[n].detach().requires_grad_() for n in self.param_names}
        with self._bound_model(leaves, group):
            out = self.model(x)  # [B*V, K, h, w] float32
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            if loss_type in ("MSE", "MSE+INTEGRAL"):
                loss = heatmap_ops.heatmap_mse_loss(out, gt, mask,
                                                    num_samples=torch.clamp(n_valid_crops, min=1.0))
            if integral:
                weight = self.cfg.TRAIN.INTEGRAL_WEIGHT if loss_type == "MSE+INTEGRAL" else 1.0
                loss = loss + weight * heatmap_ops.integral_regression_loss(
                    out, gt, mask[:, :, 0, 0], beta=self.cfg.TRAIN.INTEGRAL_BETA,
                    num_valid=counts[1])
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), grads, out[0].detach(), n_valid_crops, group

    def loss_and_grads(self, state: TrainState, images, gt_heatmaps, per_view_joint_valid,
                       frame_valid) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch and its gradient with respect to
        each of `state.params`, which stay as they are (train_step's
        arguments; only `state.params` is read).  Under a process group,
        this rank's share of both (train_step sums them over the ranks)."""
        loss, grads, _, _, _ = self._loss_and_grads(state, images, gt_heatmaps,
                                                    per_view_joint_valid, frame_valid)
        for _, bn in self._bns:
            bn.batch_stats = None
        return loss, dict(zip(self.param_names, grads))

    def train_step(self, state: TrainState, images, gt_heatmaps, per_view_joint_valid,
                   frame_valid) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on `state`, in place (JAX engine.py:126-226).

        images: float32 [B, V, H, W, 3], normalized (``device_prepare``);
        gt_heatmaps: [B, V, K, h, w]; per_view_joint_valid: [B, V, K] bool;
        frame_valid: [B] bool (padding rows are False and add no loss).
        Under view sharding images and gt_heatmaps hold this rank's views
        (``parallel.view_slice(V)``) and per_view_joint_valid all V.
        Returns (state, metrics) with metrics on the device: loss, skipped
        (the update was not applied), lr (the one this step used) and
        first_heatmap (the first crop's prediction [K, h, w], float32).
        Nothing here waits on the card.  Under a process group the batch is
        this rank's rows of the global batch; loss and skipped are the
        global batch's, and the state stays the same bits on every rank."""
        loss, grads, first_heatmap, n_valid_crops, group = self._loss_and_grads(
            state, images, gt_heatmaps, per_view_joint_valid, frame_valid)
        missing = [name for name, bn in self._bns if bn.batch_stats is None]
        if missing:
            raise RuntimeError("batch norms without batch statistics: %s" % missing[:4])

        with torch.no_grad():
            lr = self.lr_schedule(state.step)
            # The gradient exchange, a SUM (each rank's gradient is its
            # share's, not a mean over ranks), with the loss in the same
            # collective: every rank then skips or steps alike.
            g = parallel.all_reduce_sum(torch.cat([t.reshape(-1) for t in grads]
                                                  + [loss.reshape(1)]), group)
            g, loss = g[:-1], g[-1]
            ok = (torch.isfinite(loss) & (loss <= self.cfg.TRAIN.LOSS_CLIP_VALUE)
                  & (n_valid_crops > 0))
            # Adam as optax.scale_by_adam, with -lr applied outside it.
            p, mu, nu = state.flat["params"], state.flat["mu"], state.flat["nu"]
            count = state.count + 1
            new_mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
            new_nu = (1 - ADAM_B2) * torch.square(g) + ADAM_B2 * nu
            c = count.to(torch.float32)
            update = (new_mu / (1 - torch.pow(ADAM_B1, c))) / (
                torch.sqrt(new_nu / (1 - torch.pow(ADAM_B2, c))) + ADAM_EPS)
            new_p = p + (-lr) * update
            # Flax's running statistics: ra = 0.9 ra + 0.1 batch (biased var).
            batch = torch.cat([t for _, bn in self._bns for t in bn.batch_stats])
            stats = state.flat["buffers"]
            new_stats = BN_DECAY * stats + (1 - BN_DECAY) * batch
            # The step-skip, selected on the device (JAX engine.py:205-226).
            p.copy_(torch.where(ok, new_p, p))
            mu.copy_(torch.where(ok, new_mu, mu))
            nu.copy_(torch.where(ok, new_nu, nu))
            stats.copy_(torch.where(ok, new_stats, stats))
            state.count.copy_(torch.where(ok, count, state.count))
            state.step.add_(1)
        for _, bn in self._bns:
            bn.batch_stats, bn.group = None, None
        state.version += 1
        metrics = {"loss": loss, "skipped": ~ok, "lr": lr, "first_heatmap": first_heatmap}
        return state, metrics

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

    @staticmethod
    def _views(images: torch.Tensor, num_views: int) -> slice:
        """This rank's views of a frame's `num_views` (``parallel.
        view_slice``), checked against the images it was given."""
        views = parallel.view_slice(num_views)
        if images.shape[1] != views.stop - views.start:
            raise ValueError("images hold %d views; this rank holds views %d-%d of %d"
                             % (images.shape[1], views.start, views.stop - 1, num_views))
        return views

    def _flatten_normalize(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 [B, V, H, W, 3] -> normalized NHWC [B*V, H, W, 3] in the
        compute dtype; float inputs are taken as already normalized.  Under
        TPU.SPACE_TO_DEPTH_STEM (PoseResNet, even H and W) the uint8 frames
        are space-to-depth'd first, a quarter of the bytes of the normalized
        ones, and normalized as [B*V, H/2, W/2, 12] with the statistics
        tiled by 4 (JAX engine.py:256-270); the stem takes either layout."""
        B, V = images.shape[0], images.shape[1]
        flat = images.reshape((B * V,) + tuple(images.shape[2:]))
        if flat.dtype == torch.uint8:
            mean, std = self._mean, self._std
            if (self.cfg.TPU.SPACE_TO_DEPTH_STEM and self.model_type == "POSE_RESNET"
                    and flat.shape[1] % 2 == 0 and flat.shape[2] % 2 == 0):
                flat = space_to_depth(flat)
                mean, std = mean.repeat(4), std.repeat(4)
            flat = (flat.to(self.dtype) / 255.0 - mean) / std
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
        can pass the result through unconditionally.  Under a process group
        each activation's maximum is taken over every rank's rows (the
        global batch's, as JAX calibrates)."""
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
        threefry key of ``utils.prng`` (padded rows draw too; under a process
        group the global batch's ``(B * data,)`` draws, of which this rank
        keeps its data row's); MPE / HP / BSB aggregate over the valid
        (view, joint) entries by their `*_aggregate` ("AVG" or "STD").  The
        forward is int8 when ``use_int8``, with the static ``int8_scales`` of
        ``int8_calibrate`` if given.  Returns keypoints_3d [B, K, 3],
        sal_metric [B], inlier_count [B], al_metric [B] and mkpe [B], plus
        embedding [B, C] (the view-averaged pooled trunk features) for
        CORESET with AL.CORESET_FEATURES=EMBEDDING.  Under view sharding the
        images hold this rank's views (``parallel.view_slice(V)``, V from
        proj_matrices) and every output is the frame's, the same on each
        rank of the view group.
        """
        if al_strategy not in SCORING_STRATEGIES:
            raise NotImplementedError("Unknown AL strategy: %s" % al_strategy)
        if al_strategy == "RANDOM" and key is None:
            raise ValueError("the RANDOM strategy needs a PRNG key (utils.prng.PRNGKey)")
        embedding = None
        num_views = proj_matrices.shape[1]
        if al_strategy == "CORESET" and self.cfg.AL.CORESET_FEATURES == "EMBEDDING":
            heatmaps, embedding = self._features_forward(images, num_views)
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
            row = parallel.data_index()
            draws = prng.uniform(key, (B * parallel.current_mesh().data,))
            al_metric = to_device(draws[row * B:(row + 1) * B], self.device)
        elif al_strategy == "TRIANGULATION":
            al_metric = res["metric"]
        elif al_strategy == "MPE":
            al_metric = uncertainty.multi_peak_entropy(heatmaps, joint_valid, mpe_aggregate,
                                                       num_views=num_views)
        elif al_strategy == "HP":
            al_metric = uncertainty.highest_probability(heatmaps, joint_valid, hp_aggregate,
                                                        num_views=num_views)
        elif al_strategy == "BSB":
            al_metric = uncertainty.best_vs_second_best(heatmaps, joint_valid, bsb_aggregate,
                                                        num_views=num_views)
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

    def _features_forward(self, images, num_views: Optional[int] = None):
        """The standard float forward with the pooled trunk features:
        (heatmaps [B, V, K, h, w], view-averaged embedding [B, C] float32),
        shared by score_step and embed_step so the pool's and the labeled
        set's embeddings come from one function.  Never int8 and never K3,
        whatever TPU.INT8_SCORING_FORCE or PALLAS_HEAD say (JAX
        engine.py:550-567): k-center distances on requantized features buy
        noise, not speed.  `num_views` (default: the images') is the frame's
        view count; under view sharding the average is a sum over this
        rank's views, summed within the view group, over `num_views`."""
        images = self._tensor(images)
        B, V = images.shape[0], images.shape[1]
        num_views = V if num_views is None else num_views
        self._views(images, num_views)
        x = self._flatten_normalize(images).permute(0, 3, 1, 2).contiguous()
        out, feats = self.model(x, return_features=True)
        heatmaps = out.reshape((B, V) + tuple(out.shape[1:]))
        feats = feats.reshape(B, V, -1)
        if not parallel.views_split(num_views):
            return heatmaps, torch.mean(feats, dim=1)
        total = parallel.all_reduce_sum(torch.sum(feats, dim=1), parallel.view_group())
        return heatmaps, total / num_views

    @torch.inference_mode()
    def embed_step(self, images, num_views: Optional[int] = None) -> torch.Tensor:
        """Pooled trunk embeddings [B, V, H, W, 3] -> [B, C] float32: the
        AL.CORESET_FEATURES=EMBEDDING features of frames the scoring sweep
        does not visit (the labeled set).  `num_views`: the frame's view
        count when the images are this rank's share of it."""
        return self._features_forward(images, num_views)[1]

    @torch.inference_mode()
    def loss_step(self, images, gt_heatmaps, num_views: Optional[int] = None) -> torch.Tensor:
        """Per-frame heatmap MSE for CLUSTER TYPE=LOSS (reference:
        strategy.py:173-187): sum((heatmaps - gt)^2) / (h * w) per frame,
        [B].  gt_heatmaps in the port's layout [B, V, K, h, w].  Always the
        float forward.  `num_views`: the frame's view count when images and
        gt_heatmaps are this rank's share of it (summed within the view
        group)."""
        heatmaps = self.forward(images, use_int8=False)
        sq = torch.square(heatmaps - self._tensor(gt_heatmaps, torch.float32))
        h, w = heatmaps.shape[-2], heatmaps.shape[-1]
        loss = torch.sum(sq, dim=(1, 2, 3, 4)) / (h * w)
        if num_views is not None and parallel.views_split(num_views):
            self._views(heatmaps, num_views)
            loss = parallel.all_reduce_sum(loss, parallel.view_group())
        return loss

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
