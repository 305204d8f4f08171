"""Offline dataset preparation tools: the port's own copy of the JAX
package's data/prep.py (same functions, same files, byte for byte), with
this package's numpy ``Camera``.

Reference equivalents:
  * aggregate_panoptic_labels — walks raw CMU Panoptic `hdPose3d_stage1`
    per-frame JSONs into the aggregated labels file
    (dataset/panoptic_utils/aggregate_labels.py:16-97);
  * compute_gt_boxes — projects GT skeletons per camera into dilated,
    clipped 2D boxes (dataset/panoptic_utils/compute_gt_boxes.py:19-124;
    that script calls a nonexistent `triangulation.projectPoints` — fixed
    here by using the Camera distortion projection);
  * select_common_cameras CLI (dataset/ih26m_utils/ih26m_common_cams.py,
    whose farthest-point update was a no-op — fixed in data/ih26m.py).

Run as:
  python -m multi_view_active_learning_tpu_torch.data.prep aggregate --raw ... --out ...
  python -m multi_view_active_learning_tpu_torch.data.prep boxes --labels ... --out ...
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Sequence

import numpy as np

from ..ops import geometry
from ..utils import get_logger

_logger = get_logger(__name__)

IMG_W, IMG_H = 1920, 1080
BOX_DILATION = 0.1


def parse_skeleton_file(path: str):
    """One `body3DScene_XXXXXXXX.json` -> (frame_idx, [4, 19] skeleton) or
    None when no body is present."""
    m = re.search(r"body3DScene_(\d+)\.json$", path)
    idx = int(m.group(1)) if m else -1
    with open(path) as f:
        data = json.load(f)
    bodies = data.get("bodies", [])
    if not bodies:
        return None
    skel = np.asarray(bodies[0]["joints19"], dtype=np.float64).reshape(-1, 4).T
    return idx, skel.tolist()


def load_pose_cameras(pose_dir: str) -> Dict[str, Dict]:
    """Read `calibration_*.json` HD cameras (reference schema:
    aggregate_labels.py:42-52)."""
    calib_files = glob.glob(os.path.join(pose_dir, "calibration_*.json"))
    cams: Dict[str, Dict] = {}
    for cf in calib_files:
        with open(cf) as f:
            info = json.load(f)["cameras"]
        for cam in info:
            if cam.get("type") == "hd":
                cams[cam["name"]] = {
                    "R": cam["R"],
                    "t": cam["t"],
                    "K": cam["K"],
                    "dist": cam["distCoef"],
                }
    return cams


def aggregate_panoptic_labels(
    raw_root: str, split_poses: Dict[str, Sequence[str]], out_path: str
) -> None:
    """Build the aggregated labels JSON
    `{split: {pose: {frame: [4, 19], "cameras": {...}}}}`."""
    out: Dict = {}
    for split, poses in split_poses.items():
        out[split] = {}
        for pose in poses:
            pose_dir = os.path.join(raw_root, pose)
            frames = {}
            for path in sorted(
                glob.glob(os.path.join(pose_dir, "hdPose3d_stage1*", "*.json"))
            ):
                parsed = parse_skeleton_file(path)
                if parsed is not None:
                    frames[str(parsed[0])] = parsed[1]
            frames["cameras"] = load_pose_cameras(pose_dir)
            out[split][pose] = frames
            _logger.info("%s/%s: %d frames" % (split, pose, len(frames) - 1))
    with open(out_path, "w") as f:
        json.dump(out, f)


def skeleton_to_box(cam: geometry.Camera, skel_4xk: np.ndarray) -> List[int]:
    """Project a [4, K] skeleton and return the dilated, clipped box
    (l, t, r, b) (reference: compute_gt_boxes.py box math)."""
    pts = np.asarray(skel_4xk, dtype=np.float64)[:3].T  # [K, 3]
    kp2d = cam.project(pts)
    left, top = kp2d.min(axis=0)
    right, bottom = kp2d.max(axis=0)
    w, h = right - left, bottom - top
    left -= BOX_DILATION * w
    right += BOX_DILATION * w
    top -= BOX_DILATION * h
    bottom += BOX_DILATION * h
    left = int(np.clip(left, 0, IMG_W))
    right = int(np.clip(right, 0, IMG_W))
    top = int(np.clip(top, 0, IMG_H))
    bottom = int(np.clip(bottom, 0, IMG_H))
    return [left, top, right, bottom]


def compute_gt_boxes(labels_path: str, out_path: str) -> None:
    """GT boxes for every (split, pose, frame, camera) in a labels file."""
    with open(labels_path) as f:
        labels = json.load(f)
    out: Dict = {}
    for split in labels:
        out[split] = {}
        for pose in labels[split]:
            cameras = {
                name: geometry.Camera(c["R"], c["t"], c["K"], c.get("dist"))
                for name, c in labels[split][pose]["cameras"].items()
            }
            out[split][pose] = {}
            for frame_id, skel in labels[split][pose].items():
                if frame_id == "cameras":
                    continue
                out[split][pose][frame_id] = {
                    name: skeleton_to_box(cam, np.asarray(skel))
                    for name, cam in cameras.items()
                }
    with open(out_path, "w") as f:
        json.dump(out, f)


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("aggregate")
    p.add_argument("--raw", required=True)
    p.add_argument("--split_json", required=True,
                   help="JSON {split: [pose, ...]}")
    p.add_argument("--out", required=True)
    p = sub.add_parser("boxes")
    p.add_argument("--labels", required=True)
    p.add_argument("--out", required=True)
    p = sub.add_parser("common_cams")
    p.add_argument("--camera_json", required=True)
    p.add_argument("--captures", nargs="+", default=["0"])
    p.add_argument("--num_cams", type=int, default=16)
    args = parser.parse_args(argv)

    if args.cmd == "aggregate":
        with open(args.split_json) as f:
            split_poses = json.load(f)
        aggregate_panoptic_labels(args.raw, split_poses, args.out)
    elif args.cmd == "boxes":
        compute_gt_boxes(args.labels, args.out)
    elif args.cmd == "common_cams":
        from .ih26m import select_common_cameras

        with open(args.camera_json) as f:
            all_cam = json.load(f)
        print(json.dumps(select_common_cameras(all_cam, args.captures, args.num_cams)))


if __name__ == "__main__":
    main()
