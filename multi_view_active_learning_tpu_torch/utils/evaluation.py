"""Pose evaluation metrics on the host: MKPE (MPJPE), 3D-PCK and 3D-PCKh.

The port's own copy of the JAX package's utils/evaluation.py (reference:
utils/evaluation.py:61-208, per-sample loops there, one vectorized numpy
expression each here; masking, normalization and the strict `<`
thresholds are the reference's).  The inputs are small ([N, K, 3]
keypoints the eval loop has already fetched), so they stay in numpy.

Shapes: pred_3d and gt_3d [N, K, 3]; valid [N, K].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from . import get_logger

PCK_THRESHOLDS_MM = (1, 2, 3, 4, 5)
PCKH_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def _dists(pred_3d, gt_3d, valid=None) -> np.ndarray:
    d = np.square(np.asarray(pred_3d) - np.asarray(gt_3d))  # [N, K, 3]
    if valid is not None:
        d = np.where(np.asarray(valid)[..., None] > 0, d, 0.0)
    return np.sqrt(np.sum(d, axis=-1))  # [N, K]


def compute_mkpe(pred_3d, gt_3d, valid) -> np.float32:
    """Mean keypoint error: each joint's error summed over samples over its
    valid count, then averaged over joints (reference:
    utils/evaluation.py:198-208).  A joint with no valid sample (0/0 in the
    reference) is left out of the joint mean, with a warning."""
    valid = np.asarray(valid)
    kpe = np.sum(_dists(pred_3d, gt_3d, valid), axis=0)  # [K]
    count = np.sum(valid, axis=0)  # [K]
    has_support = count > 0
    if not has_support.all():
        get_logger(__name__).warning(
            "MKPE: %d joint(s) have no valid samples in this eval set; excluded from the "
            "joint mean." % int((~has_support).sum()))
    return np.float32(np.mean(kpe[has_support] / count[has_support]))


def compute_3d_pck(pred_3d, gt_3d, valid, threshold_mm: float) -> np.ndarray:
    """Per-joint PCK at an absolute threshold over the valid joints
    (reference: utils/evaluation.py:177-195).  [K]."""
    valid = np.asarray(valid) > 0
    hit = (_dists(pred_3d, gt_3d) < threshold_mm) & valid
    return np.sum(hit, axis=0) / np.sum(valid, axis=0)


def compute_3d_pckh(pred_3d, gt_3d, threshold: float) -> np.ndarray:
    """Per-joint PCKh: the threshold scales with each sample's distance
    between joints 0 and 1 (the head segment on Panoptic); every joint
    counts, with no validity mask (reference: utils/evaluation.py:150-174).
    [K]."""
    gt_3d = np.asarray(gt_3d)
    seg = np.sqrt(np.sum(np.square(gt_3d[:, 0, :] - gt_3d[:, 1, :]), axis=-1))
    hit = _dists(pred_3d, gt_3d) < (seg * threshold)[:, None]
    return np.mean(hit.astype(np.float32), axis=0)


def compute_3d_pck_figure(pred_3d, gt_3d, valid, thresholds: Sequence[float] = PCK_THRESHOLDS_MM
                          ) -> Tuple[Sequence[float], list]:
    return thresholds, [compute_3d_pck(pred_3d, gt_3d, valid, t).tolist() for t in thresholds]


def compute_3d_pckh_figure(pred_3d, gt_3d, thresholds: Sequence[float] = PCKH_THRESHOLDS
                           ) -> Tuple[Sequence[float], list]:
    return thresholds, [compute_3d_pckh(pred_3d, gt_3d, t).tolist() for t in thresholds]
