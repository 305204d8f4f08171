"""Training figures as HWC uint8 arrays: heatmap grids, 2D keypoint
overlays and PCK curves.

The port's own copy of the JAX package's utils/visualization.py
(reference: utils/visualization.py:14-64, evaluation.plot_pckh_figure at
utils/evaluation.py:109-118).  matplotlib is optional: without it the PCK
curve is a one-pixel-per-threshold strip, so training never needs a
plotting stack.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def _fig_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()


_PCK_FIG = None  # one figure, reused: creating it costs more than plotting


def plot_pckh_figure(thresholds: Sequence[float], pck: Sequence[float]) -> np.ndarray:
    """PCK against threshold as an image (reference:
    utils/evaluation.py:109-118)."""
    global _PCK_FIG
    plt = _mpl()
    if plt is None:
        strip = (np.asarray(pck, dtype=np.float64) * 255).astype(np.uint8)
        return np.tile(strip[None, :, None], (16, 1, 3))
    if _PCK_FIG is None:
        _PCK_FIG = plt.subplots(figsize=(4, 3))
    fig, axis = _PCK_FIG
    axis.clear()
    axis.set_ylim((0.0, 1.0))
    axis.plot(thresholds, pck, "r+")
    axis.plot(thresholds, pck)
    axis.grid(True)
    return _fig_to_array(fig)


def heatmap_grid(heatmaps: np.ndarray, max_cols: int = 8) -> np.ndarray:
    """[K, h, w] heatmaps tiled into one grayscale image, each map scaled
    to its own range."""
    heatmaps = np.asarray(heatmaps)
    k, h, w = heatmaps.shape
    cols = min(k, max_cols)
    rows = (k + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w), dtype=np.float64)
    for i in range(k):
        r, c = divmod(i, cols)
        hm = heatmaps[i]
        rng = hm.max() - hm.min()
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = (hm - hm.min()) / rng if rng > 0 else 0.0
    img = (grid * 255).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


def overlay_keypoints(image: np.ndarray, keypoints_2d: np.ndarray, color=(255, 0, 0),
                      radius: int = 2, gt_keypoints_2d: Optional[np.ndarray] = None,
                      gt_color=(0, 255, 0)) -> np.ndarray:
    """Predicted (and GT) 2D keypoints drawn as squares on an HWC uint8
    image."""
    img = np.array(image, dtype=np.uint8, copy=True)
    h, w = img.shape[:2]

    def draw(kps, col):
        for x, y in np.asarray(kps):
            xi, yi = int(round(x)), int(round(y))
            if 0 <= xi < w and 0 <= yi < h:
                img[max(yi - radius, 0):min(yi + radius + 1, h),
                    max(xi - radius, 0):min(xi + radius + 1, w)] = col

    draw(keypoints_2d, color)
    if gt_keypoints_2d is not None:
        draw(gt_keypoints_2d, gt_color)
    return img


def pred_vs_gt_heatmaps(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """The predicted heatmap grid above the GT one."""
    top, bottom = heatmap_grid(pred), heatmap_grid(gt)
    w = max(top.shape[1], bottom.shape[1])

    def pad(a):
        return np.pad(a, ((0, 0), (0, w - a.shape[1]), (0, 0)))

    return np.concatenate([pad(top), pad(bottom)], axis=0)
