"""Batched RANSAC-DLT triangulation on the device.

Port of the JAX package's ops/triangulate.py (reference:
utils/triangulation.py:168-338).  No dynamic shapes:

  * the RANSAC pair set is a static [P, 2] array of view pairs (all C(V, 2)
    in combination order, or a seeded subset of them);
  * every pair of every joint of every frame is triangulated at once: the
    4x4 pair systems of a [B, K, P] batch, solved by closed-form adjugate
    inverse iteration on A^T A (method="power", the default), or by
    eigh / SVD;
  * inlier sets are boolean masks [B, K, P, V]; "largest inlier set wins,
    first on ties" is an argmax (utils/triangulation.py:293-307);
  * the refit over the winning inlier set is a masked DLT: a zero row adds
    nothing to A^T A, so masking a row equals removing it;
  * ``direct_optimization`` refines the refit by Levenberg-Marquardt on the
    inlier views' Huber-robust reprojection error (``_huber_refine``), a
    fixed number of steps for every joint of every frame at once.

The heatmap decode goes through K1 (``kernels/decode.py``).  Heatmaps come
in the port's layout [B, V, K, h, w], so each map is one contiguous row of
the kernel's input.  Everything after the decode is float32.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import decode as decode_kernel
from . import geometry, heatmap


def all_view_pairs(num_views: int, n_iters: int = -1, seed: int = 0) -> np.ndarray:
    """Static RANSAC pair set: all C(V, 2) pairs in combination order.

    When 0 < n_iters < C(V, 2), a seeded numpy permutation picks n_iters
    pairs -- the same pairs as the JAX package for the same seed.
    """
    pairs = np.array(list(itertools.combinations(range(num_views), 2)), dtype=np.int32)
    if 0 < n_iters < len(pairs):
        rng = np.random.default_rng(seed)
        pairs = pairs[rng.permutation(len(pairs))[:n_iters]]
    return pairs


def _dlt_rows(proj: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """DLT rows for all views at once.

    proj: [..., V, 3, 4]; points: [..., V, 2] -> rows [..., V, 2, 4] with
    rows[v, 0] = x_v P_v[2] - P_v[0], rows[v, 1] = y_v P_v[2] - P_v[1]
    (reference: utils/triangulation.py:341-368).
    """
    ax = points[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]  # [..., V, 4]
    ay = points[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    return torch.stack([ax, ay], dim=-2)


def _det3_of(e) -> torch.Tensor:
    """Determinant of the 3x3 matrix whose (a, b) entry is ``e(a, b)``."""
    return (
        e(0, 0) * (e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1))
        - e(0, 1) * (e(1, 0) * e(2, 2) - e(1, 2) * e(2, 0))
        + e(0, 2) * (e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0))
    )


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3]."""
    return _det3_of(lambda a, b: m[..., a, b])


def _adjugate4(M: torch.Tensor) -> torch.Tensor:
    """Adjugate of [..., 4, 4] in closed form: adj(M) = det(M) inv(M), the
    transpose of the 16 signed 3x3 cofactors (elementwise math, no linalg).
    Each minor is read through integer element views of M: indexing with a
    list of rows would copy that list to the device, a host sync each time."""
    idx = (0, 1, 2, 3)
    cof_rows = []
    for i in idx:
        rows = [r for r in idx if r != i]
        cof_row = []
        for j in idx:
            cols = [c for c in idx if c != j]
            minor = _det3_of(lambda a, b: M[..., rows[a], cols[b]])
            cof_row.append(((-1.0) ** (i + j)) * minor)
        cof_rows.append(torch.stack(cof_row, dim=-1))
    cof = torch.stack(cof_rows, dim=-2)  # [..., 4, 4] cofactor matrix
    return cof.transpose(-2, -1)


def _null_vector_power(M: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvector of a PSD [..., 4, 4] by adjugate inverse
    iteration.

    adj(M) = det(M) inv(M) shares M's eigenvectors with eigenvalues
    det / lambda_i, so its dominant eigenvector is M's smallest; each
    multiply contracts by lambda_min / lambda_next however wide the top of
    the spectrum.  For an exactly singular M one multiply is exact.
    """
    scale = torch.clamp(torch.amax(torch.abs(M), dim=(-2, -1), keepdim=True), min=1e-30)
    Mn = M / scale
    # Ridge of 1e-6 of the normalized scale keeps adj nonzero for rank <= 2
    # degeneracies (coincident views) and leaves genuine near-null systems'
    # eigen-gap intact.
    Mn = Mn + 1e-6 * torch.eye(4, dtype=M.dtype, device=M.device)
    adj = _adjugate4(Mn)
    v = torch.full(M.shape[:-2] + (4,), 0.5, dtype=M.dtype, device=M.device)
    for _ in range(3):
        v = torch.sum(adj * v[..., None, :], dim=-1)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _gram(A: torch.Tensor) -> torch.Tensor:
    """A^T A for [..., R, 4] -> [..., 4, 4], as a float32 multiply-reduce
    (no matmul: the result must not depend on the TF32 flag)."""
    Af = A.to(torch.float32)
    return torch.sum(Af[..., :, :, None] * Af[..., :, None, :], dim=-3)


def _null_vector(A: torch.Tensor, method: str) -> torch.Tensor:
    """Smallest right-singular vector of A: [..., R, 4] -> [..., 4]."""
    if method == "eigh":
        _, vecs = torch.linalg.eigh(_gram(A))  # ascending eigenvalues
        return vecs[..., :, 0]
    if method == "power":
        return _null_vector_power(_gram(A))
    if method == "svd":
        _, _, vh = torch.linalg.svd(A, full_matrices=False)
        return vh[..., 3, :]
    raise ValueError("Unknown DLT method: %s" % method)


def dlt_triangulate(
    proj: torch.Tensor,
    points: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    method: str = "power",
) -> torch.Tensor:
    """Weighted / masked DLT for one 3D point per batch entry.

    proj: [..., V, 3, 4]; points: [..., V, 2]; weights: [..., V] (None = all
    ones).  A view of weight 0 has zero rows, exactly as if dropped.
    Returns [..., 3].
    """
    rows = _dlt_rows(proj, points)  # [..., V, 2, 4]
    if weights is not None:
        rows = rows * weights[..., None, None]
    A = rows.reshape(rows.shape[:-3] + (-1, 4))  # [..., 2V, 4]
    return geometry.homogeneous_to_euclidean(_null_vector(A, method))


def _solve3(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for [..., 3, 3] H and [..., 3] b by Cramer's rule
    (cofactors, no batched linalg); a |det| below 1e-30 is taken as 1e-30."""
    det = _det3(H)
    cols = []
    for j in range(3):
        Hj = H.clone()
        Hj[..., :, j] = b
        cols.append(_det3(Hj))
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    return torch.stack(cols, dim=-1) / det[..., None]


def _project_with_jacobian(proj: torch.Tensor, x: torch.Tensor):
    """Pinhole projection of x [B, K, 3] into every view of proj
    [B, 1, V, 3, 4] and its 2x3 Jacobian in closed form:
    (u, v) = (a, b) / c with (a, b, c) = P [x, 1], d(u, v)/dx_i =
    (P_0i - u P_2i, P_1i - v P_2i) / c.  A view with c == 0 projects to
    (a, b), as geometry.homogeneous_to_euclidean's guard does, and its
    Jacobian is the one of that branch.  Returns ([B, K, V, 2],
    [B, K, V, 2, 3])."""
    homo = geometry.euclidean_to_homogeneous(x)[:, :, None, None, :]  # [B, K, 1, 1, 4]
    abc = torch.sum(proj * homo, dim=-1)  # [B, K, V, 3]
    c = abc[..., 2:3]
    zero = c == 0
    c = torch.where(zero, torch.ones_like(c), c)
    uv = abc[..., :2] / c
    p2 = torch.where(zero[..., None], torch.zeros_like(proj[..., 2:3, :3]), proj[..., 2:3, :3])
    jac = (proj[..., :2, :3] - uv[..., None] * p2) / c[..., None]
    return uv, jac


def _huber_refine(x0: torch.Tensor, proj: torch.Tensor, points: torch.Tensor,
                  mask: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Direct reprojection-error minimization with a Huber loss for every
    joint of every frame: the JAX package's ``_huber_refine`` written out
    over [B, K] (reference: utils/triangulation.py:319-337, scipy's
    least_squares(loss="huber") over the inlier views' half-L2 errors).

    Levenberg-Marquardt with IRLS Huber weights and a fixed ``n_iters``
    steps: the cost C(x) = 1/2 sum_v rho(r_v^2) mask_v, r_v = 1/2 ||e_v||,
    rho(z) = z for z <= 1 else 2 sqrt(z) - 1; damping lam * trace(H) / 3,
    lam from 1e-3, a step kept only if it lowers C (then lam / 10, else
    lam * 10).  The 2x3 Jacobian is written in closed form
    (``_project_with_jacobian``) where the JAX package takes ``jacfwd``.

    x0: [B, K, 3]; proj: [B, 1, V, 3, 4]; points: [B, K, V, 2]; mask:
    [B, K, V], 1.0 for inlier views.  Returns the refined [B, K, 3]."""
    eps = 1e-12
    eye = torch.eye(3, dtype=x0.dtype, device=x0.device)

    def cost(e):
        z = 0.25 * torch.sum(torch.square(e), dim=-1)
        rho = torch.where(z <= 1.0, z, 2.0 * torch.sqrt(torch.clamp(z, min=eps)) - 1.0)
        return 0.5 * torch.sum(rho * mask, dim=-1)

    x = x0
    lam = torch.full(x0.shape[:-1], 1e-3, dtype=x0.dtype, device=x0.device)
    for _ in range(n_iters):
        uv, J = _project_with_jacobian(proj, x)
        e = uv - points  # [B, K, V, 2]
        # IRLS weight rho'(z): 1 in the quadratic zone, 1 / r beyond the knee.
        z = 0.25 * torch.sum(torch.square(e), dim=-1)
        w = torch.where(z <= 1.0, torch.ones_like(z), 1.0 / torch.sqrt(torch.clamp(z, min=eps)))
        w = w * mask
        g = torch.sum(J * (e * w[..., None])[..., None], dim=(-3, -2))  # [B, K, 3]
        H = torch.sum(J[..., :, None] * J[..., None, :] * w[..., None, None, None],
                      dim=(-4, -3))  # [B, K, 3, 3]
        diag_scale = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 3.0, min=eps)
        delta = _solve3(H + (lam * diag_scale)[..., None, None] * eye, -g)
        x_new = x + delta
        uv_new, _ = _project_with_jacobian(proj, x_new)
        better = cost(uv_new - points) < cost(e)
        x = torch.where(better[..., None], x_new, x)
        lam = torch.where(better, lam * 0.1, lam * 10.0)
    return x


def _ransac(
    proj: torch.Tensor,
    points: torch.Tensor,
    pairs: torch.Tensor,
    epsilon: float,
    method: str,
    confidence: Optional[torch.Tensor] = None,
    direct_optimization: bool = False,
    direct_opt_iters: int = 32,
):
    """Fixed-shape RANSAC for every joint of every frame at once: the JAX
    package's ``_ransac_single_joint`` written out over [B, K, P, V].

    proj: [B, V, 3, 4]; points: [B, K, V, 2]; pairs: [P, 2] view indices;
    confidence: [B, K, V] or None.  Returns (keypoints_3d [B, K, 3], mean
    inlier reprojection error [B, K], inlier count [B, K]).

    Sampled views always count as inliers, the largest set wins, the first
    pair (in pair order) wins ties, and the estimate and error are
    recomputed on the winning set (utils/triangulation.py:284-316).  With
    `confidence`, the refit is weighted least squares (rows scaled by
    sqrt(conf)); selection and the reported error and count are unchanged.
    ``direct_optimization`` refines the refit on the winning set's views
    (``_huber_refine``, unweighted) and the error is the refined point's
    (utils/triangulation.py:319-337).
    """
    num_views = proj.shape[1]
    proj_bk = proj[:, None]  # [B, 1, V, 3, 4]
    rows = _dlt_rows(proj_bk, points)  # [B, K, V, 2, 4]

    # Hypotheses: triangulate every pair at once.
    pair_rows = rows[:, :, pairs]  # [B, K, P, 2, 2, 4]
    A_pairs = pair_rows.reshape(pair_rows.shape[:3] + (4, 4))
    x_pairs = geometry.homogeneous_to_euclidean(_null_vector(A_pairs, method))  # [B, K, P, 3]

    # Scoring: reproject every hypothesis into every view.
    err = geometry.reprojection_error(
        x_pairs[..., None, :],  # [B, K, P, 1, 3]
        points[:, :, None, :, None, :],  # [B, K, 1, V, 1, 2]
        proj[:, None, None],  # [B, 1, 1, V, 3, 4]
    )[..., 0]  # [B, K, P, V]
    views = torch.arange(num_views, device=pairs.device)
    sampled = (pairs[:, 0:1] == views) | (pairs[:, 1:2] == views)  # [P, V]
    inliers = (err < epsilon) | sampled  # [B, K, P, V]
    counts = torch.sum(inliers, dim=-1)  # [B, K, P]
    best = torch.argmax(counts, dim=-1)  # first maximum == reference tie-break
    best_mask = torch.gather(
        inliers, 2, best[:, :, None, None].expand(-1, -1, 1, num_views)
    )[:, :, 0].to(torch.float32)  # [B, K, V]

    # Refit: masked DLT over the winning inlier set.
    refit_w = best_mask
    if confidence is not None:
        refit_w = best_mask * torch.sqrt(torch.clamp(confidence, min=1e-3))
    keypoints_3d = dlt_triangulate(proj_bk, points, weights=refit_w, method=method)
    if direct_optimization:
        keypoints_3d = _huber_refine(keypoints_3d, proj_bk, points, best_mask, direct_opt_iters)
    final_err = geometry.reprojection_error(
        keypoints_3d[..., None, :],  # [B, K, 1, 3]
        points[..., None, :],  # [B, K, V, 1, 2]
        proj_bk,  # [B, 1, V, 3, 4]
    )[..., 0]  # [B, K, V]
    inlier_total = torch.sum(best_mask, dim=-1)
    mean_err = torch.sum(final_err * best_mask, dim=-1) / inlier_total
    return keypoints_3d, mean_err, inlier_total


def triangulate_frames(
    heatmaps: torch.Tensor,
    proj_matrices: torch.Tensor,
    valid_joints: torch.Tensor,
    pairs: torch.Tensor,
    stride: int = 4,
    use_soft_argmax: bool = False,
    use_reprojection_xe: bool = False,
    sigma: float = 1.0,
    epsilon: float = 5.0,
    method: str = "power",
    confidence_weighted: bool = False,
    direct_optimization: bool = False,
    direct_opt_iters: int = 32,
) -> Dict[str, torch.Tensor]:
    """Triangulate a whole batch of multi-view frames.

    Args:
      heatmaps: [B, V, K, h, w] float32 (the port's model layout; the JAX
        package takes [B, V, h, w, K] and moves the axis to this layout).
      proj_matrices: [B, V, 3, 4].
      valid_joints: [B, K] bool.
      pairs: [P, 2] RANSAC pair set from `all_view_pairs`.
      stride: heatmap-to-image stride.

    Returns a dict with keypoints_3d [B, K, 3] (zeros at invalid joints),
    keypoints_2d [B, V, K, 2], metric [B] (mean reprojection error over
    valid joints, or the reprojection-XE score), inlier_count [B] (min over
    valid joints), per_joint_error [B, K] and per_joint_inliers [B, K].

    Reference contract: utils/triangulation.py:168-233.
    """
    V = heatmaps.shape[1]
    pairs = torch.as_tensor(pairs, dtype=torch.int64, device=heatmaps.device)
    keypoints_2d, peaks = decode_kernel.decode_keypoints(
        heatmaps, float(stride), valid_joints[:, None, :], use_soft_argmax,
        with_peak=True,
    )  # [B, V, K, 2], [B, V, K]
    points_kv = keypoints_2d.transpose(1, 2)  # [B, K, V, 2]
    conf = None
    if confidence_weighted:
        # Per-view heatmap peak (from the same fused pass) as the WLS weight,
        # normalized per joint so the weighting is scale-invariant.
        conf = peaks.transpose(1, 2)  # [B, K, V]
        conf = conf / torch.clamp(torch.amax(conf, dim=-1, keepdim=True), min=1e-6)
    kp3d, err, inlier = _ransac(proj_matrices, points_kv, pairs, epsilon, method, conf,
                                direct_optimization, direct_opt_iters)

    validf = valid_joints.to(torch.float32)
    kp3d = kp3d * validf[..., None]
    n_valid = torch.clamp(torch.sum(validf, dim=-1), min=1.0)
    mean_err = torch.sum(torch.where(valid_joints, err, torch.zeros_like(err)), dim=-1) / n_valid
    inlier_count = torch.amin(
        torch.where(valid_joints, inlier, torch.full_like(inlier, float(V + 1))), dim=-1
    )

    if use_reprojection_xe:
        metric = reprojection_xe(kp3d, proj_matrices, heatmaps, sigma)
    else:
        metric = mean_err

    return {
        "keypoints_3d": kp3d,
        "keypoints_2d": keypoints_2d,
        "metric": metric,
        "inlier_count": inlier_count,
        "per_joint_error": err,
        "per_joint_inliers": inlier,
    }


def reprojection_xe(
    keypoints_3d: torch.Tensor,
    proj_matrices: torch.Tensor,
    heatmaps: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """MSE between the predicted heatmaps and Gaussians re-rendered at the
    reprojected keypoints, summed over views and joints
    (reference: utils/triangulation.py:236-257).

    keypoints_3d: [B, K, 3]; proj_matrices: [B, V, 3, 4];
    heatmaps: [B, V, K, h, w] -> [B].

    Quirk kept from the reference: the reprojected keypoints are in image
    coordinates while the Gaussian grid is heatmap-sized -- there is no
    division by the stride.
    """
    h, w = heatmaps.shape[-2], heatmaps.shape[-1]
    kp2d = geometry.project_points(proj_matrices, keypoints_3d[:, None, :, :])  # [B, V, K, 2]
    gauss = heatmap.render_gaussian_heatmaps(kp2d, h, w, sigma)  # [B, V, K, h, w]
    sq = torch.square(heatmaps - gauss)
    return torch.sum(sq, dim=(1, 2, 3, 4)) / (h * w)
