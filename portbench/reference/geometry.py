"""The reference's decode, RANSAC-DLT triangulation and sweep metrics.

Written from the reference repo's equations (utils/evaluation.py:13-30,
utils/triangulation.py:168-338) with the choices the configuration states
(AL.RANSAC_N_ITERS view pairs drawn by a seeded numpy permutation,
AL.RANSAC_EPSILON, TPU.DLT_METHOD "power"): each pair's hypothesis is the
null vector of its 4x4 DLT system by three steps of adjugate inverse
iteration on the normalized A^T A with a 1e-6 ridge; a view is an inlier
when its half-L2 reprojection error is below epsilon, the sampled views
always count, the largest set wins with the first pair on ties, and the
point is refit by DLT over the winning set.  Float64 throughout; the
decode is exact in float32.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch


def view_pairs(num_views: int, n_iters: int, seed: int) -> np.ndarray:
    pairs = np.array(list(itertools.combinations(range(num_views), 2)), dtype=np.int64)
    if 0 < n_iters < len(pairs):
        pairs = pairs[np.random.default_rng(seed).permutation(len(pairs))[:n_iters]]
    return pairs


def decode(heatmaps: torch.Tensor, stride: float):
    """Hard argmax, first maximum on ties: [..., h, w] float32 ->
    (coords [..., 2] in image pixels, peak [...])."""
    h, w = heatmaps.shape[-2:]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (h * w,)).to(torch.float32)
    idx = torch.argmax(flat, dim=-1)
    peak = torch.gather(flat, -1, idx[..., None])[..., 0]
    x = (idx % w).to(torch.float32) * stride
    y = (idx // w).to(torch.float32) * stride
    return torch.stack([x, y], dim=-1), peak


def _det3(e):
    return (e(0, 0) * (e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1))
            - e(0, 1) * (e(1, 0) * e(2, 2) - e(1, 2) * e(2, 0))
            + e(0, 2) * (e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)))


def _adjugate(M: torch.Tensor) -> torch.Tensor:
    rows = []
    for i in range(4):
        ri = [r for r in range(4) if r != i]
        row = []
        for j in range(4):
            cj = [c for c in range(4) if c != j]
            row.append(((-1.0) ** (i + j)) * _det3(lambda a, b: M[..., ri[a], cj[b]]))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2).transpose(-2, -1)


def null_vector(A: torch.Tensor) -> torch.Tensor:
    """[..., R, 4] -> [..., 4]: three adjugate inverse-iteration steps."""
    M = torch.einsum("...ri,...rj->...ij", A, A)
    scale = torch.clamp(torch.amax(torch.abs(M), dim=(-2, -1), keepdim=True), min=1e-30)
    M = M / scale + 1e-6 * torch.eye(4, dtype=M.dtype, device=M.device)
    adj = _adjugate(M)
    v = torch.full(M.shape[:-2] + (4,), 0.5, dtype=M.dtype, device=M.device)
    for _ in range(3):
        v = torch.einsum("...ij,...j->...i", adj, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _euclid(p: torch.Tensor) -> torch.Tensor:
    z = p[..., -1:]
    return p[..., :-1] / torch.where(z == 0, torch.ones_like(z), z)


def _dlt_rows(proj: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """proj [..., V, 3, 4], pts [..., V, 2] -> [..., V, 2, 4]."""
    ax = pts[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]
    ay = pts[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    return torch.stack([ax, ay], dim=-2)


def _half_l2(x3: torch.Tensor, pts: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """x3 [..., 3], pts [..., V, 2], proj [..., V, 3, 4] -> [..., V]."""
    homo = torch.cat([x3, torch.ones_like(x3[..., :1])], dim=-1)
    rep = _euclid(torch.einsum("...vij,...j->...vi", proj, homo))
    return 0.5 * torch.linalg.vector_norm(pts - rep, dim=-1)


def triangulate(points: torch.Tensor, proj: torch.Tensor, pairs: torch.Tensor,
                epsilon: float) -> Dict[str, torch.Tensor]:
    """points [B, V, K, 2] (image pixels), proj [B, V, 3, 4], pairs [P, 2]
    -> keypoints_3d [B, K, 3], error [B, K] (mean half-L2 over the
    winning set), inliers [B, K]."""
    pts = points.to(torch.float64).transpose(1, 2)  # [B, K, V, 2]
    proj = proj.to(torch.float64)
    B, K, V, _ = pts.shape
    rows = _dlt_rows(proj[:, None], pts)  # [B, K, V, 2, 4]
    hyp_rows = rows[:, :, pairs].reshape(B, K, len(pairs), 4, 4)
    hyp = _euclid(null_vector(hyp_rows))  # [B, K, P, 3]
    err = _half_l2(hyp, pts[:, :, None], proj[:, None, None])  # [B, K, P, V]
    views = torch.arange(V, device=pairs.device)
    sampled = (pairs[:, 0:1] == views) | (pairs[:, 1:2] == views)
    inl = (err < epsilon) | sampled
    best = torch.argmax(inl.sum(-1), dim=-1)  # first maximum
    mask = torch.gather(inl, 2, best[:, :, None, None].expand(B, K, 1, V))[:, :, 0]
    maskf = mask.to(torch.float64)
    A = (rows * maskf[..., None, None]).reshape(B, K, 2 * V, 4)
    x3 = _euclid(null_vector(A))
    final = _half_l2(x3, pts, proj[:, None])
    n = maskf.sum(-1)
    return {"keypoints_3d": x3, "error": (final * maskf).sum(-1) / n, "inliers": n}


def frame_metrics(tri: Dict[str, torch.Tensor], joints_3d: torch.Tensor,
                  joint_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The sweep's per-frame outputs under TRIANGULATION: keypoints_3d
    (zero at invalid joints), sal_metric = al_metric (mean error over valid
    joints), inlier_count (least over valid joints), mkpe (mean distance to
    the ground truth over valid joints)."""
    valid = joint_valid.to(torch.float64)
    kp = tri["keypoints_3d"] * valid[..., None]
    n = torch.clamp(valid.sum(-1), min=1.0)
    err = (torch.where(joint_valid, tri["error"], torch.zeros_like(tri["error"]))).sum(-1) / n
    V1 = float(torch.finfo(torch.float64).max)
    inl = torch.amin(torch.where(joint_valid, tri["inliers"], torch.full_like(tri["inliers"], V1)), -1)
    d = torch.linalg.vector_norm(kp - joints_3d.to(torch.float64), dim=-1) * valid
    return {"keypoints_3d": kp, "sal_metric": err, "al_metric": err, "inlier_count": inl,
            "mkpe": d.sum(-1) / n}
