"""Camera model and projective geometry.

Host side (numpy): the `Camera` class used to build rigs and the square
crop boxes of the data pipeline (reference: utils/triangulation.py:25-134,
433-456).  Device side (torch): batched
pinhole projection and homogeneous converters used by the triangulation,
written over arbitrary leading batch dimensions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def denormalize_image(image: np.ndarray) -> np.ndarray:
    """An ImageNet-normalized HWC float image back to uint8 pixels."""
    return np.uint8(np.clip(255.0 * (image * IMAGENET_STD + IMAGENET_MEAN), 0, 255))


# ---------------------------------------------------------------------------
# Host-side camera model (numpy).
# ---------------------------------------------------------------------------


class Camera:
    """Pinhole camera with optional Brown distortion.

    Convention: x_cam = R @ x_world + t; pixel = K @ x_cam (then distortion).
    """

    def __init__(self, R, t, K, dist=None, name: str = ""):
        self.R = np.asarray(R, dtype=np.float64).copy()
        if self.R.shape != (3, 3):
            raise ValueError("R must be 3x3, got %s" % (self.R.shape,))
        self.t = np.asarray(t, dtype=np.float64).reshape(3, 1).copy()
        self.K = np.asarray(K, dtype=np.float64).copy()
        if self.K.shape != (3, 3):
            raise ValueError("K must be 3x3, got %s" % (self.K.shape,))
        self.dist = None if dist is None else np.asarray(dist, dtype=np.float64).flatten()
        self.name = name

    def update_after_crop(self, bbox) -> None:
        """Shift the principal point after cropping to bbox=(l, u, r, b)."""
        left, upper, _, _ = bbox
        self.K[0, 2] -= left
        self.K[1, 2] -= upper

    def update_after_resize(self, image_shape, new_width, new_height) -> None:
        """Scale focal lengths and principal point after a resize."""
        height, width = image_shape
        sx = new_width / width
        sy = new_height / height
        self.K[0, 0] *= sx
        self.K[1, 1] *= sy
        self.K[0, 2] *= sx
        self.K[1, 2] *= sy

    @property
    def extrinsics(self) -> np.ndarray:
        return np.hstack([self.R, self.t])

    @property
    def projection(self) -> np.ndarray:
        return self.K @ self.extrinsics

    def project(self, points_3d: np.ndarray) -> np.ndarray:
        """Project world points [N, 3] -> pixels [N, 2], with distortion when
        the camera has it."""
        if self.dist is not None:
            return project_points_distorted_np(
                points_3d, self.K, self.R, self.t, self.dist
            )
        return project_points_np(self.projection, points_3d)


def project_points_np(proj: np.ndarray, points_3d: np.ndarray) -> np.ndarray:
    """Distortion-free projection, numpy host path."""
    homo = np.hstack([points_3d, np.ones((len(points_3d), 1))])
    result = homo @ proj.T
    z = result[:, 2:3]
    z = np.where(z == 0, np.ones_like(z), z)
    return result[:, :2] / z


def project_points_distorted_np(X, K, R, t, kd) -> np.ndarray:
    """Brown-model distorted projection, with the reference's in-place
    sequencing: the updated x coordinate feeds the y row, and the updated
    tangential x feeds the y tangential term (utils/triangulation.py:449-455)."""
    X = np.asarray(X, dtype=np.float64)
    x = np.asarray(R @ X.T + t.reshape(3, 1))
    x[0:2, :] = x[0:2, :] / x[2, :]
    r = x[0, :] * x[0, :] + x[1, :] * x[1, :]
    radial = 1 + kd[0] * r + kd[1] * r * r + kd[4] * r * r * r
    x[0, :] = (
        x[0, :] * radial
        + 2 * kd[2] * x[0, :] * x[1, :]
        + kd[3] * (r + 2 * x[0, :] * x[0, :])
    )
    x[1, :] = (
        x[1, :] * radial
        + 2 * kd[3] * x[0, :] * x[1, :]
        + kd[2] * (r + 2 * x[1, :] * x[1, :])
    )
    x[0, :] = K[0, 0] * x[0, :] + K[0, 1] * x[1, :] + K[0, 2]
    x[1, :] = K[1, 0] * x[0, :] + K[1, 1] * x[1, :] + K[1, 2]
    return x.T[:, :2]


# ---------------------------------------------------------------------------
# Bounding-box helpers (host side; reference: utils/triangulation.py:96-134).
# ---------------------------------------------------------------------------


def get_square_bbox(bbox) -> Tuple[int, int, int, int]:
    """Stretch the short side so the box is square."""
    left, upper, right, lower = bbox
    width, height = right - left, lower - upper
    if width > height:
        y_center = (upper + lower) // 2
        upper = y_center - width // 2
        lower = upper + width
    else:
        x_center = (left + right) // 2
        left = x_center - height // 2
        right = left + height
    return left, upper, right, lower


def scale_bbox(bbox, scale: float) -> Tuple[int, int, int, int]:
    left, upper, right, lower = bbox
    width, height = right - left, lower - upper
    x_center, y_center = (right + left) // 2, (lower + upper) // 2
    new_width, new_height = int(scale * width), int(scale * height)
    new_left = x_center - new_width // 2
    new_right = new_left + new_width
    new_upper = y_center - new_height // 2
    new_lower = new_upper + new_height
    return new_left, new_upper, new_right, new_lower


def crop_image(image: np.ndarray, bbox) -> np.ndarray:
    """Crop with zero-fill for out-of-bounds regions
    (reference: utils/triangulation.py:77-93)."""
    left, upper, right, lower = (int(v) for v in bbox)
    out_h, out_w = lower - upper, right - left
    out = np.zeros((out_h, out_w) + image.shape[2:], dtype=image.dtype)
    src_y0, src_y1 = max(upper, 0), min(lower, image.shape[0])
    src_x0, src_x1 = max(left, 0), min(right, image.shape[1])
    if src_y1 > src_y0 and src_x1 > src_x0:
        out[src_y0 - upper : src_y1 - upper, src_x0 - left : src_x1 - left] = image[
            src_y0:src_y1, src_x0:src_x1
        ]
    return out


# ---------------------------------------------------------------------------
# Device-side (torch) projective geometry -- batched, fixed-shape.
# ---------------------------------------------------------------------------


def homogeneous_to_euclidean(points: torch.Tensor) -> torch.Tensor:
    """[..., M+1] -> [..., M] with a z == 0 guard."""
    z = points[..., -1:]
    z = torch.where(z == 0, torch.ones_like(z), z)
    return points[..., :-1] / z


def euclidean_to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """[..., M] -> [..., M+1]."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def project_points(proj: torch.Tensor, points_3d: torch.Tensor) -> torch.Tensor:
    """Batched pinhole projection.

    proj: [..., 3, 4]; points_3d: [..., N, 3] -> [..., N, 2].
    Leading batch dims of `proj` and `points_3d` broadcast.
    """
    homo = euclidean_to_homogeneous(points_3d)  # [..., N, 4]
    # Multiply-reduce rather than matmul: the result must not depend on the
    # process-wide TF32 matmul flag (pixel coordinates need full float32).
    result = torch.sum(proj[..., None, :, :] * homo[..., None, :], dim=-1)
    return homogeneous_to_euclidean(result)  # [..., N, 2]


def reprojection_error(
    keypoints_3d: torch.Tensor,
    keypoints_2d: torch.Tensor,
    proj: torch.Tensor,
) -> torch.Tensor:
    """Half-L2 reprojection error per (point, view).

    keypoints_3d: [..., N, 3]; keypoints_2d: [..., V, N, 2];
    proj: [..., V, 3, 4] -> errors [..., V, N].
    """
    reproj = project_points(proj, keypoints_3d[..., None, :, :])  # [..., V, N, 2]
    diff = keypoints_2d - reproj
    return 0.5 * torch.sqrt(torch.sum(diff * diff, dim=-1))
