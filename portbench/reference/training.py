"""The reference's training steps: the configuration's model in train mode,
the reference repo's masked heatmap MSE (pose_estimators/loss.py:10-24:
the summed squared error over samples x h x w, here over the real crops),
Adam as torch.optim.Adam without weight decay (beta 0.9 / 0.999, eps 1e-8,
bias-corrected), a step skipped when its loss is not finite or exceeds
TRAIN.LOSS_CLIP_VALUE, and BatchNorm running averages updated with the
batch's mean and biased variance at momentum 0.1.  Targets are unnormalized
Gaussians of sigma DATA.SIGMA at each keypoint over the stride
(dataset/dataset.py:198-207).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import arch, counting
from .precision import TrainingArithmetic

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BN_MOMENTUM = 0.1


def gaussian_targets(keypoints_2d: torch.Tensor, stride: int, size: int, sigma: float):
    """[..., 2] image pixels -> [..., size / stride, size / stride]."""
    h = size // stride
    kp = keypoints_2d.to(torch.float32) / float(stride)
    grid = torch.arange(h, dtype=torch.float32, device=kp.device)
    dx2 = torch.square(grid - kp[..., 0:1])
    dy2 = torch.square(grid - kp[..., 1:2])
    return torch.exp(-(dy2[..., :, None] + dx2[..., None, :]) / (2.0 * sigma ** 2))


def run_steps(model: Dict, state: Dict[str, torch.Tensor], batches: List[Dict], lr: float,
              loss_clip: float, dtype=torch.float32, fp8: bool = False,
              adam: Optional[Tuple[Dict, Dict, int]] = None, remat: bool = False) -> Dict:
    """Train from `state` (float32 weights and BN statistics under the
    reference names) on `batches` ({"x": [N, 3, H, W] float32, "target":
    [N, K, h, w]}, every crop real), with Adam's moments and count from
    `adam` (mu, nu, count) or fresh.  With `remat`, each conv unit's
    activations are recomputed in the backward pass (the same arithmetic;
    a batch of many crops then fits).  Returns the losses, the first
    step's gradient per parameter and its first crop's heatmaps, and the
    parameters and BN statistics after the last step."""
    spec = arch.Params()
    arch.forward(model, spec, counting.MacCounter(),
                 torch.empty((1,) + tuple(batches[0]["x"].shape[1:]), device="meta"))
    trainable = [n for n, _, k in spec.spec
                 if k in ("conv", "head", "linear", "table", "weight", "bias")]
    stat_names = [n for n, _, k in spec.spec if k in ("running_mean", "running_var")]
    params = {n: state[n].detach().clone().to(torch.float32) for n in trainable}
    stats = {n: state[n].detach().clone().to(torch.float32) for n in stat_names}
    if adam is None:
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        count = 0
    else:
        mu = {n: adam[0][n].to(torch.float32) for n in params}
        nu = {n: adam[1][n].to(torch.float32) for n in params}
        count = int(adam[2])
    losses, first_grad, first_output, first_stats = [], None, None, None
    for batch in batches:
        leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
        ops = TrainingArithmetic(dtype, fp8, remat)
        out = arch.forward(model, arch.Params({**leaves, **stats, **_counts(spec)}), ops, batch["x"])
        records = list(ops.records)  # the forward's (a recomputation records again)
        n, _, h, w = out.shape
        loss = torch.sum(torch.square(out - batch["target"])) / (n * h * w)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss = loss.detach()
        losses.append(float(loss))
        if first_grad is None:
            first_grad = {n: g.detach() for n, g in zip(leaves, grads)}
            first_output = out[0].detach()
        if not (torch.isfinite(loss) and float(loss) <= loss_clip):
            continue
        count += 1
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                mu[name] = ADAM_B1 * mu[name] + (1 - ADAM_B1) * g
                nu[name] = ADAM_B2 * nu[name] + (1 - ADAM_B2) * g * g
                m_hat = mu[name] / (1 - ADAM_B1 ** count)
                v_hat = nu[name] / (1 - ADAM_B2 ** count)
                params[name] = p - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
            for i, (mean, var) in enumerate(records):
                rm, rv = stat_names[2 * i], stat_names[2 * i + 1]
                stats[rm] = (1 - BN_MOMENTUM) * stats[rm] + BN_MOMENTUM * mean
                stats[rv] = (1 - BN_MOMENTUM) * stats[rv] + BN_MOMENTUM * var
            if first_stats is None:
                first_stats = dict(stats)
    return {"losses": losses, "first_grad": first_grad, "first_output": first_output,
            "first_stats": first_stats, "params": params, "stats": stats}


def _counts(spec: arch.Params) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros((), dtype=torch.int64) for n, _, k in spec.spec if k == "count"}
