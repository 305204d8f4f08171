"""The reference's view preparation, written from the reference repo's
dataset (dataset/dataset.py:158-220, utils/triangulation.py:77-134): JPEG
decode, BGR flip, square box, crop with zero fill, Lanczos resize to the
model input, and the camera's intrinsics after the crop and the resize.
NumPy and PIL only; it reads the tree's files and nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from PIL import Image


def square_box(box):
    left, upper, right, lower = box
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


def scaled_box(box, scale: float):
    left, upper, right, lower = box
    width, height = right - left, lower - upper
    x_center, y_center = (right + left) // 2, (lower + upper) // 2
    new_width, new_height = int(scale * width), int(scale * height)
    new_left = x_center - new_width // 2
    new_upper = y_center - new_height // 2
    return new_left, new_upper, new_left + new_width, new_upper + new_height


def crop(image: np.ndarray, box) -> np.ndarray:
    left, upper, right, lower = (int(v) for v in box)
    out = np.zeros((lower - upper, right - left) + image.shape[2:], dtype=image.dtype)
    y0, y1 = max(upper, 0), min(lower, image.shape[0])
    x0, x1 = max(left, 0), min(right, image.shape[1])
    if y1 > y0 and x1 > x0:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = image[y0:y1, x0:x1]
    return out


def view_camera(camera: Dict, box, size: int) -> np.ndarray:
    """K [R | t] after the crop to `box` and the resize to size x size."""
    K = np.asarray(camera["K"], np.float64).copy()
    R = np.asarray(camera["R"], np.float64)
    t = np.asarray(camera["t"], np.float64).reshape(3, 1)
    left, upper, right, lower = box
    K[0, 2] -= left
    K[1, 2] -= upper
    sx, sy = size / (right - left), size / (lower - upper)
    K[0, 0] *= sx
    K[1, 1] *= sy
    K[0, 2] *= sx
    K[1, 2] *= sy
    return K @ np.hstack([R, t])


def project(camera: Dict, proj: np.ndarray, points: np.ndarray) -> np.ndarray:
    """World points [N, 3] -> pixels [N, 2] through the view's camera, with
    the Brown model when it has coefficients (the reference's
    project_3d_points_to_image_plane_without_distortion otherwise)."""
    kd = np.asarray(camera.get("dist") or [0.0] * 5, np.float64).flatten()
    if not np.any(kd):
        homo = np.hstack([points, np.ones((len(points), 1))]) @ proj.T
        return homo[:, :2] / homo[:, 2:3]
    raise NotImplementedError("distorted cameras are not in the benchmark's trees")


def prepare_frames(frames: List[Dict], size: int, scale_bbox: float = 1.0) -> Dict[str, np.ndarray]:
    """The model inputs of `frames` (datagen.frame_records entries):
    images uint8 [B, V, size, size, 3], proj float32 [B, V, 3, 4],
    keypoints_2d float32 [B, V, K, 2] after the resize, joints_3d float32
    [B, K, 3]."""
    images, projs, kps = [], [], []
    for frame in frames:
        f_img, f_proj, f_kp = [], [], []
        for view in frame["views"]:
            box = scaled_box(square_box(tuple(view["box"])), scale_bbox)
            with Image.open(view["path"]) as im:
                image = np.asarray(im)[..., ::-1]
            image = Image.fromarray(crop(image, box)).resize((size, size), resample=Image.LANCZOS)
            f_img.append(np.asarray(image, dtype=np.uint8))
            proj = view_camera(view["camera"], box, size)
            f_proj.append(proj.astype(np.float32))
            f_kp.append(project(view["camera"], proj, frame["3d"]).astype(np.float32))
        images.append(np.stack(f_img))
        projs.append(np.stack(f_proj))
        kps.append(np.stack(f_kp))
    return {"images": np.stack(images), "proj": np.stack(projs), "keypoints_2d": np.stack(kps),
            "joints_3d": np.stack([f["3d"] for f in frames]).astype(np.float32)}
