"""Heatmap synthesis and decoding, batched on the device.

These are the plain PyTorch versions of the decode that
``kernels/decode.py`` fuses into one CUDA pass (K1), and the bbox-scaled
decode that runs through it:

  * Gaussian heatmap rendering (reference: dataset/dataset.py:198-207);
  * hard-argmax 2D decode (reference: utils/evaluation.py:13-30);
  * spatial soft-argmax (kornia.spatial_soft_argmax2d, reference:
    utils/triangulation.py:192-199);
  * the training losses: the masked heatmap MSE of the reference and the
    integral (soft-argmax) regression loss of the JAX package.

All functions treat the trailing two axes as (h, w) and broadcast over any
leading batch axes.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..kernels import decode as decode_kernel


def render_gaussian_heatmaps(
    keypoints: torch.Tensor,
    height: int,
    width: int,
    sigma: float,
) -> torch.Tensor:
    """Render unnormalized Gaussians exp(-||p - kp||^2 / (2 sigma^2)).

    keypoints: [..., 2] in heatmap-grid coordinates (x, y).
    Returns [..., height, width] float32.
    """
    xs = torch.arange(width, dtype=torch.float32, device=keypoints.device)
    ys = torch.arange(height, dtype=torch.float32, device=keypoints.device)
    kx = keypoints[..., 0:1]  # [..., 1]
    ky = keypoints[..., 1:2]
    dx2 = torch.square(xs - kx)  # [..., width]
    dy2 = torch.square(ys - ky)  # [..., height]
    exponent = dy2[..., :, None] + dx2[..., None, :]  # [..., h, w]
    return torch.exp(-exponent / (2.0 * (sigma**2)))


def decode_argmax(
    heatmaps: torch.Tensor, stride: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard-argmax decode: [..., h, w] -> (coords [..., 2], peak value [...]).

    coords are (x, y) * stride with x = idx % w, y = idx // w; ties go to the
    first index (torch.argmax's documented rule, as jnp.argmax's).
    """
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,))
    idx = torch.argmax(flat, dim=-1)
    peak = torch.gather(flat, -1, idx[..., None])[..., 0]
    x = (idx % w).to(torch.float32) * stride
    y = torch.div(idx, w, rounding_mode="floor").to(torch.float32) * stride
    return torch.stack([x, y], dim=-1), peak


def soft_argmax(
    heatmaps: torch.Tensor,
    stride: float = 1.0,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Spatial soft-argmax: softmax-weighted expected (x, y) coordinates,
    scaled by `stride`.  heatmaps: [..., h, w] -> coords [..., 2]."""
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,))
    probs = torch.softmax(temperature * flat, dim=-1)
    probs = probs.reshape(heatmaps.shape[:-2] + (h, w))
    xs = torch.arange(w, dtype=torch.float32, device=heatmaps.device)
    ys = torch.arange(h, dtype=torch.float32, device=heatmaps.device)
    x = torch.sum(torch.sum(probs, dim=-2) * xs, dim=-1)  # expect over x
    y = torch.sum(torch.sum(probs, dim=-1) * ys, dim=-1)
    return torch.stack([x, y], dim=-1) * stride


def decode_keypoints(
    heatmaps: torch.Tensor,
    stride: float,
    valid: torch.Tensor,
    use_soft_argmax: bool = False,
) -> torch.Tensor:
    """Decode [..., K, h, w] heatmaps to image-space keypoints [..., K, 2].

    Invalid joints decode to (0, 0) (reference utils/evaluation.py:21-23).
    `valid`: [..., K] bool.
    """
    if use_soft_argmax:
        coords = soft_argmax(heatmaps, stride=stride)
    else:
        coords, _ = decode_argmax(heatmaps, stride=stride)
    return torch.where(valid[..., None], coords, torch.zeros_like(coords))


def decode_keypoints_bbox(
    heatmaps: torch.Tensor,
    bbox,
    use_soft_argmax: bool = False,
    with_peak: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Decode heatmaps to bbox-relative pixel coordinates through K1.

    heatmaps: [..., K, h, w]; bbox: [..., 4] (left, top, right, bottom) ->
    coords [..., K, 2]: the hard argmax (or soft-argmax) at stride 1, x
    scaled by the box width over w and y by its height over h.  The
    reference's get_pred_coordinates (utils/evaluation.py:33-58) mixes the
    two and so holds only for square boxes; this is the JAX package's
    non-square fix (ops/heatmap.py:105-130).  On a CUDA tensor the decode is
    K1's launch; on the CPU its plain version.  ``with_peak=True`` also
    returns each map's peak value [..., K] from the same launch."""
    lead = heatmaps.shape[:-2]
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    out = decode_kernel.fused_decode(heatmaps.reshape(-1, h * w).to(torch.float32), w, 1.0)
    coords = (out["soft_coords"] if use_soft_argmax else out["coords"]).reshape(lead + (2,))
    bbox = torch.as_tensor(bbox, dtype=torch.float32, device=heatmaps.device)
    width = (bbox[..., 2] - bbox[..., 0])[..., None, None]
    height = (bbox[..., 3] - bbox[..., 1])[..., None, None]
    coords = coords * torch.cat([width / float(w), height / float(h)], dim=-1)
    if with_peak:
        return coords, out["peak"].reshape(lead)
    return coords


def integral_regression_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    joint_valid: Optional[torch.Tensor] = None,
    beta: float = 10.0,
    peak_threshold: float = 0.1,
    num_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Soft-argmax coordinate regression (the JAX package's TRAIN.LOSS
    INTEGRAL, ops/heatmap.py:133-183 there; integral pose regression, Sun
    et al., ECCV'18).

    pred / target: [N, K, h, w]; joint_valid: [N, K] bool or None.  The
    prediction is the softmax(beta * heatmap) expectation; the target is
    the GT heatmap's linear expectation (its keypoint while the Gaussian
    lies in the crop).  Joints whose GT peak is at most `peak_threshold`
    are dropped (`integral_valid`).  The error is L1 in units of the
    heatmap's extent, |dx| / w + |dy| / h, summed over the joints kept and
    divided by their count, or by `num_valid` when given (the global batch's
    count, of which this batch holds a share)."""
    h, w = pred.shape[-2], pred.shape[-1]
    pred_xy = soft_argmax(pred, stride=1.0, temperature=beta)  # [N, K, 2]
    tgt_sum = torch.sum(target, dim=(-2, -1))  # [N, K]
    probs = target / torch.clamp(tgt_sum, min=1e-8)[..., None, None]
    xs = torch.arange(w, dtype=torch.float32, device=pred.device)
    ys = torch.arange(h, dtype=torch.float32, device=pred.device)
    tx = torch.sum(torch.sum(probs, dim=-2) * xs, dim=-1)
    ty = torch.sum(torch.sum(probs, dim=-1) * ys, dim=-1)
    tgt_xy = torch.stack([tx, ty], dim=-1)  # [N, K, 2]
    valid = integral_valid(target, joint_valid, peak_threshold)  # [N, K]
    extent = torch.tensor([float(w), float(h)], dtype=torch.float32, device=pred.device)
    err = torch.sum(torch.abs(pred_xy - tgt_xy) / extent, dim=-1)  # [N, K]
    err = torch.where(valid, err, torch.zeros_like(err))
    if num_valid is None:
        num_valid = torch.sum(valid)
    return torch.sum(err) / torch.clamp(num_valid, min=1)


def integral_valid(target: torch.Tensor, joint_valid: Optional[torch.Tensor] = None,
                   peak_threshold: float = 0.1) -> torch.Tensor:
    """The joints `integral_regression_loss` keeps, [N, K] bool: GT peak
    above `peak_threshold`, and `joint_valid` when given."""
    valid = torch.amax(target, dim=(-2, -1)) > peak_threshold
    return valid if joint_valid is None else valid & joint_valid


def heatmap_mse_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    joint_valid: Optional[torch.Tensor] = None,
    num_samples: Optional[Union[torch.Tensor, float]] = None,
) -> torch.Tensor:
    """Masked heatmap MSE with the reference's normalization: the summed
    squared error over (samples * h * w), not over joints (reference:
    pose_estimators/loss.py:14-20).

    pred / target: [N, K, h, w]; joint_valid: a bool mask that broadcasts
    against them ([N, K, 1, 1] per sample and joint); num_samples: the
    count of real samples in the denominator (default N), so zero-loss
    padding rows do not dilute a tail batch."""
    err = torch.square(pred - target)
    if joint_valid is not None:
        err = torch.where(joint_valid, err, torch.zeros_like(err))
    n, h, w = pred.shape[0], pred.shape[-2], pred.shape[-1]
    if num_samples is None:
        num_samples = n
    return torch.sum(err) / (num_samples * h * w)
