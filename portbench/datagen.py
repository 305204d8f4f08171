"""Synthetic CMU-Panoptic trees for the benchmark, made from a seed.

A frozen copy of the port's ``data/synthetic.py::generate_panoptic_tree``
and its render helpers (numpy and PIL only), so the benchmark's inputs do
not move when the program's generator does.  The tree has the Panoptic
schema the port's dataset reads (labels.json, boxes.json, split.json and
``<pose>/hdImgs/<cam>/<cam>_<frame>.jpg``): a ring of cameras around a
drifting skeleton whose joints render as discs.

One change from the original, which changes no byte it writes: the
views are rendered and encoded by worker processes, a block of frames
each, while the caller goes on with other set-up work (``start_tree``).
The skeletons, cameras and boxes are drawn in this process in the
original order.  Every run makes its tree anew, so every run does the same
set-up work.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

FULL_W, FULL_H = 256, 256
TRAIN_POSE, VAL_POSE = "171026_pose1", "171026_pose2"
SAMPLE_RATE = 25
VIEWS_PER_WORKER = 256  # a worker process pays its start-up for at least this many views


def ring_camera(idx: int, num: int, radius: float, focal: float) -> Dict:
    ang = 2 * np.pi * idx / num + 0.07
    pos = np.array([radius * np.cos(ang), 30.0 + 8.0 * np.sin(3 * ang), radius * np.sin(ang)])
    z = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    t = -R @ pos
    K = np.array([[focal, 0.0, FULL_W / 2], [0.0, focal, FULL_H / 2], [0, 0, 1.0]])
    return {"R": R.tolist(), "t": t.tolist(), "K": K.tolist(), "dist": [0.0, 0.0, 0.0, 0.0, 0.0]}


def skeleton_walk(rng, num_frames: int, num_joints: int, scale: float) -> List[np.ndarray]:
    base = rng.normal(scale=scale, size=(num_joints, 3))
    frames = []
    cur = base
    for _ in range(num_frames):
        cur = 0.9 * cur + 0.1 * base + rng.normal(scale=scale * 0.08, size=cur.shape)
        frames.append(cur.copy())
    return frames


def project_distorted(X, K, R, t, kd) -> np.ndarray:
    """Brown-model projection with the reference's in-place sequencing
    (the original generator projects through it, with zero coefficients)."""
    X = np.asarray(X, dtype=np.float64)
    x = np.asarray(R @ X.T + t.reshape(3, 1))
    x[0:2, :] = x[0:2, :] / x[2, :]
    r = x[0, :] * x[0, :] + x[1, :] * x[1, :]
    radial = 1 + kd[0] * r + kd[1] * r * r + kd[4] * r * r * r
    x[0, :] = x[0, :] * radial + 2 * kd[2] * x[0, :] * x[1, :] + kd[3] * (r + 2 * x[0, :] * x[0, :])
    x[1, :] = x[1, :] * radial + 2 * kd[3] * x[0, :] * x[1, :] + kd[2] * (r + 2 * x[1, :] * x[1, :])
    x[0, :] = K[0, 0] * x[0, :] + K[0, 1] * x[1, :] + K[0, 2]
    x[1, :] = K[1, 0] * x[0, :] + K[1, 1] * x[1, :] + K[1, 2]
    return x.T[:, :2]


def camera_project(cam: Dict, points: np.ndarray) -> np.ndarray:
    return project_distorted(points, np.asarray(cam["K"], np.float64),
                             np.asarray(cam["R"], np.float64),
                             np.asarray(cam["t"], np.float64).reshape(3, 1),
                             np.asarray(cam["dist"], np.float64).flatten())


def joint_color(k: int) -> np.ndarray:
    return np.array([80 + (k * 37) % 175, 80 + (k * 73) % 175, 80 + (k * 101) % 175], np.uint8)


def draw_disc(img, ys, xs, x: float, y: float, color: np.ndarray) -> None:
    if not (0 <= x < FULL_W and 0 <= y < FULL_H):
        return
    x0, x1 = max(int(np.floor(x - 4)), 0), min(int(np.ceil(x + 4)) + 1, FULL_W)
    y0, y1 = max(int(np.floor(y - 4)), 0), min(int(np.ceil(y + 4)) + 1, FULL_H)
    d2 = (xs[y0:y1, x0:x1] - x) ** 2 + (ys[y0:y1, x0:x1] - y) ** 2
    img[y0:y1, x0:x1][d2 < 16.0] = color


def render_view(kp2d: np.ndarray, cam_index: int) -> np.ndarray:
    """Bright discs at the projected joints over a static per-camera
    background (a seeded texture)."""
    bg_rng = np.random.default_rng(1000 + cam_index)
    base = bg_rng.integers(10, 60, size=(8, 8, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(base).resize((FULL_W, FULL_H), Image.BILINEAR)).copy()
    ys, xs = np.mgrid[0:FULL_H, 0:FULL_W]
    for k, (x, y) in enumerate(kp2d):
        draw_disc(img, ys, xs, x, y, joint_color(k))
    return img


def _render_block(jobs: List[Tuple[str, int, List[List[float]]]], quality: int) -> int:
    """Worker: render and write the views of a block of frames."""
    for path, cam_index, kp2d in jobs:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(render_view(np.asarray(kp2d), cam_index)).save(path, quality=quality)
    return len(jobs)


def plan_tree(root: str, num_train_frames: int, num_val_frames: int, num_joints: int,
              num_cameras: int, seed: int):
    """Everything but the pixels, drawn in the original generator's order:
    (labels, boxes, split, render jobs)."""
    rng = np.random.default_rng(seed)
    cameras = {"00_%02d" % i: ring_camera(i, num_cameras, radius=170.0, focal=300.0)
               for i in range(num_cameras)}
    cam_names = sorted(cameras)
    labels: Dict = {"train": {}, "val": {}}
    boxes: Dict = {"train": {}, "val": {}}
    split: Dict = {"train": {}, "val": {}, "test": {},
                   "cameras": {"train": cam_names, "val": cam_names, "test": cam_names}}
    jobs = []
    for split_name, pose_name, n_frames in (("train", TRAIN_POSE, num_train_frames),
                                            ("val", VAL_POSE, num_val_frames)):
        skels = skeleton_walk(rng, n_frames, num_joints, scale=18.0)
        labels[split_name][pose_name] = {"cameras": cameras}
        boxes[split_name][pose_name] = {}
        split[split_name][pose_name] = [[0, n_frames * SAMPLE_RATE]]
        for i, skel in enumerate(skels):
            frame_id = i * SAMPLE_RATE
            labels[split_name][pose_name][str(frame_id)] = np.vstack(
                [skel.T, np.ones((1, num_joints))]).tolist()
            boxes[split_name][pose_name][str(frame_id)] = {}
            for cam_name in cam_names:
                kp2d = camera_project(cameras[cam_name], skel)
                left, top = kp2d.min(axis=0) - 12
                right, bottom = kp2d.max(axis=0) + 12
                boxes[split_name][pose_name][str(frame_id)][cam_name] = [
                    int(left), int(top), int(right), int(bottom)]
                path = os.path.join(root, pose_name, "hdImgs", cam_name,
                                    "%s_%08d.jpg" % (cam_name, frame_id))
                jobs.append((path, cam_names.index(cam_name), kp2d.tolist()))
    split["test"] = dict(split["val"])
    return labels, boxes, split, jobs


class Tree:
    """A tree in the making under `root`: its JSON files are written, its
    views are being rendered.  ``wait`` returns `root` once every view is
    on disk and the workers have ended."""

    def __init__(self, root: str, jobs: List, quality: int, workers: Optional[int]):
        self.root, self.total = root, len(jobs)
        if workers is None:
            workers = min(8, os.cpu_count() or 1, -(-len(jobs) // VIEWS_PER_WORKER))
        blocks = [jobs[i::workers] for i in range(workers) if jobs[i::workers]]
        self.pool, self.futures = None, []
        if len(blocks) <= 1:
            self.done = sum(_render_block(block, quality) for block in blocks)
            return
        self.pool = ProcessPoolExecutor(len(blocks), mp_context=multiprocessing.get_context("spawn"))
        self.futures = [self.pool.submit(_render_block, block, quality) for block in blocks]
        self.done = 0

    def wait(self) -> str:
        if self.pool is not None:
            try:
                self.done = sum(f.result() for f in self.futures)
            finally:
                self.pool.shutdown(wait=True)
                self.pool = None
        if self.done != self.total:
            raise RuntimeError("rendered %d of %d views" % (self.done, self.total))
        return self.root


def start_tree(root: str, seed: int, num_train_frames: int, num_val_frames: int,
               num_joints: int, num_cameras: int, image_quality: int = 90,
               workers: Optional[int] = None) -> Tree:
    """Write the tree's JSON files under `root` (a new directory) and start
    rendering its views: by `workers` processes, or by default one per
    VIEWS_PER_WORKER views, at most one a core and 8 (one view block is
    rendered here, at once)."""
    os.makedirs(root)
    labels, boxes, split, jobs = plan_tree(root, num_train_frames, num_val_frames,
                                           num_joints, num_cameras, seed)
    for name, obj in (("labels.json", labels), ("boxes.json", boxes), ("split.json", split)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(obj, f)
    return Tree(root, jobs, image_quality, workers)


def frame_records(root: str, split_name: str) -> List[Dict]:
    """The frames of a split in the order the Panoptic reader walks them
    (frame ids ascending): guid, 3D joints [K, 3], camera names, and per
    camera its camera dict, box and image path."""
    with open(os.path.join(root, "labels.json")) as f:
        labels = json.load(f)
    with open(os.path.join(root, "boxes.json")) as f:
        boxes = json.load(f)
    with open(os.path.join(root, "split.json")) as f:
        split = json.load(f)
    cams = list(split["cameras"][split_name])
    label_split = "val" if split_name == "test" else split_name
    out = []
    for pose in split[split_name]:
        cameras = labels[label_split][pose]["cameras"]
        for start, stop in split[split_name][pose]:
            for frame_id in range(start, stop, SAMPLE_RATE):
                fid = str(frame_id)
                if fid not in labels[label_split][pose]:
                    continue
                skel = np.asarray(labels[label_split][pose][fid], dtype=np.float64)
                out.append({
                    "guid": "%s%s-%d" % (pose[:6], pose[-1], frame_id),
                    "3d": skel[:3].T,
                    "views": [{"camera": cameras[c], "box": boxes[label_split][pose][fid][c],
                               "path": os.path.join(root, pose, "hdImgs", c,
                                                    "%s_%08d.jpg" % (c, frame_id))}
                              for c in cams],
                })
    return out
