"""Heatmap synthesis and decoding, batched on the device.

These are the plain PyTorch versions of the decode that
``kernels/decode.py`` fuses into one CUDA pass (K1), and the bbox-scaled
decode that runs through it:

  * Gaussian heatmap rendering (reference: dataset/dataset.py:198-207);
  * hard-argmax 2D decode (reference: utils/evaluation.py:13-30);
  * spatial soft-argmax (kornia.spatial_soft_argmax2d, reference:
    utils/triangulation.py:192-199).

All functions treat the trailing two axes as (h, w) and broadcast over any
leading batch axes.
"""

from __future__ import annotations

from typing import Tuple

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
) -> torch.Tensor:
    """Decode heatmaps to bbox-relative pixel coordinates through K1.

    heatmaps: [..., K, h, w]; bbox: [..., 4] (left, top, right, bottom) ->
    coords [..., K, 2]: the hard argmax (or soft-argmax) at stride 1, x
    scaled by the box width over w and y by its height over h.  The
    reference's get_pred_coordinates (utils/evaluation.py:33-58) mixes the
    two and so holds only for square boxes; this is the JAX package's
    non-square fix (ops/heatmap.py:105-130).  On a CUDA tensor the decode is
    K1's launch; on the CPU its plain version."""
    lead = heatmaps.shape[:-2]
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    out = decode_kernel.fused_decode(heatmaps.reshape(-1, h * w).to(torch.float32), w, 1.0)
    coords = (out["soft_coords"] if use_soft_argmax else out["coords"]).reshape(lead + (2,))
    bbox = torch.as_tensor(bbox, dtype=torch.float32, device=heatmaps.device)
    width = (bbox[..., 2] - bbox[..., 0])[..., None, None]
    height = (bbox[..., 3] - bbox[..., 1])[..., None, None]
    return coords * torch.cat([width / float(w), height / float(h)], dim=-1)
