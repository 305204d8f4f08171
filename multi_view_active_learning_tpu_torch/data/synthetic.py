"""Synthetic dataset generator for tests and benchmarks (the port's own
copy of the JAX package's data/synthetic.py: numpy and PIL only, so the
trees it writes are byte-equal to that module's).

Writes a miniature CMU-Panoptic-schema tree (labels.json / boxes.json /
split.json / pose/hdImgs/<cam>/<cam>_<frame>.jpg) — the exact JSON layout the
reference reads (dataset/panoptic_dataset.py:21-66, schema produced by
dataset/panoptic_utils/aggregate_labels.py) — and an InterHand2.6M-schema
variant.  The reference has no offline fixture story at all (its dataset
tests require manifold access, SURVEY.md §4); this generator is what makes
the data layer testable hermetically.

Scenes are camera rings around a randomly drifting K-joint "skeleton"; each
joint renders as a bright disc so a model can actually learn localization.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
from PIL import Image

from ..ops import geometry

FULL_W, FULL_H = 256, 256


def _ring_camera(idx: int, num: int, radius: float, focal: float) -> Dict:
    ang = 2 * np.pi * idx / num + 0.07
    pos = np.array(
        [radius * np.cos(ang), 30.0 + 8.0 * np.sin(3 * ang), radius * np.sin(ang)]
    )
    z = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    t = -R @ pos
    K = np.array([[focal, 0.0, FULL_W / 2], [0.0, focal, FULL_H / 2], [0, 0, 1.0]])
    return {
        "R": R.tolist(),
        "t": t.tolist(),
        "K": K.tolist(),
        "dist": [0.0, 0.0, 0.0, 0.0, 0.0],
    }


def _skeleton_walk(rng, num_frames: int, num_joints: int, scale: float):
    base = rng.normal(scale=scale, size=(num_joints, 3))
    frames = []
    cur = base
    for _ in range(num_frames):
        cur = 0.9 * cur + 0.1 * base + rng.normal(scale=scale * 0.08, size=cur.shape)
        frames.append(cur.copy())
    return frames


def _joint_color(k: int) -> np.ndarray:
    return np.array(
        [80 + (k * 37) % 175, 80 + (k * 73) % 175, 80 + (k * 101) % 175],
        np.uint8,
    )


def _draw_disc(img, ys, xs, x: float, y: float, color: np.ndarray) -> None:
    if not (0 <= x < FULL_W and 0 <= y < FULL_H):
        return
    # Only pixels less than 4 from the centre are in the disc: the full-frame
    # distance test, restricted to the box around it (the same pixels).
    x0, x1 = max(int(np.floor(x - 4)), 0), min(int(np.ceil(x + 4)) + 1, FULL_W)
    y0, y1 = max(int(np.floor(y - 4)), 0), min(int(np.ceil(y + 4)) + 1, FULL_H)
    d2 = (xs[y0:y1, x0:x1] - x) ** 2 + (ys[y0:y1, x0:x1] - y) ** 2
    img[y0:y1, x0:x1][d2 < 16.0] = color


def _draw_segment(img, a, b, width: float, color: np.ndarray) -> None:
    """Rasterize a line segment of the given width (bbox-limited distance
    field, so per-bone cost is O(segment area) not O(image area))."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lo = np.floor(np.minimum(a, b) - width).astype(int)
    hi = np.ceil(np.maximum(a, b) + width).astype(int) + 1
    x0, y0 = max(lo[0], 0), max(lo[1], 0)
    x1, y1 = min(hi[0], FULL_W), min(hi[1], FULL_H)
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    d = b - a
    denom = float(d @ d)
    if denom < 1e-9:
        t = np.zeros_like(xs, np.float64)
    else:
        t = ((xs - a[0]) * d[0] + (ys - a[1]) * d[1]) / denom
    t = np.clip(t, 0.0, 1.0)
    px = a[0] + t * d[0]
    py = a[1] + t * d[1]
    mask = (xs - px) ** 2 + (ys - py) ** 2 < (width / 2.0) ** 2
    region = img[y0:y1, x0:x1]
    region[mask] = color


def _render_view(
    kp2d: np.ndarray,
    rng,
    cam_index: int = 0,
    bones=None,
    distractors=None,
) -> np.ndarray:
    """Bright discs at projected joints over a static per-camera background.

    The background is deterministic per camera (a seeded texture), NOT
    per-frame noise: iid per-frame backgrounds invite shortcut memorization
    — a model can key heatmaps off the unique noise pattern of each training
    frame and never learn the discs, making validation metrics on the
    synthetic set meaningless.

    `bones`: optional (i, j) joint-index pairs rendered as wide gray
    segments UNDER the discs — the context cue the heterogeneous pool
    (generate_heterogeneous_tree) uses to make real joints distinguishable
    from distractor discs.  `distractors`: optional (x, y, joint_index)
    triples rendered as discs pointwise IDENTICAL to the real joint discs
    (same radius, same palette color) but detached from the skeleton — a
    color-template detector cannot tell them from real joints; only the
    bone-attachment context can.
    """
    bg_rng = np.random.default_rng(1000 + cam_index)
    base = bg_rng.integers(10, 60, size=(8, 8, 3)).astype(np.uint8)
    img = np.asarray(
        Image.fromarray(base).resize((FULL_W, FULL_H), Image.BILINEAR)
    ).copy()
    bone_color = np.array([150, 150, 150], np.uint8)
    for i, j in bones or ():
        _draw_segment(img, kp2d[i], kp2d[j], 5.0, bone_color)
    ys, xs = np.mgrid[0:FULL_H, 0:FULL_W]
    for x, y, k in distractors or ():
        _draw_disc(img, ys, xs, x, y, _joint_color(k))
    for k, (x, y) in enumerate(kp2d):
        _draw_disc(img, ys, xs, x, y, _joint_color(k))
    return img


def generate_panoptic_tree(
    root: str,
    num_train_frames: int = 12,
    num_val_frames: int = 6,
    num_joints: int = 19,
    num_cameras: int = 4,
    sample_rate: int = 25,
    seed: int = 0,
    image_quality: int = 90,
) -> str:
    """Build the tree and return `root`.  Frame ids are multiples of
    `sample_rate` so the indexer's strided walk hits every frame."""
    rng = np.random.default_rng(seed)
    cameras = {
        "00_%02d" % i: _ring_camera(i, num_cameras, radius=170.0, focal=300.0)
        for i in range(num_cameras)
    }
    cam_names = sorted(cameras.keys())
    labels: Dict = {"train": {}, "val": {}}
    boxes: Dict = {"train": {}, "val": {}}
    split: Dict = {
        "train": {},
        "val": {},
        "test": {},
        "cameras": {"train": cam_names, "val": cam_names, "test": cam_names},
    }

    for split_name, pose_name, n_frames in (
        ("train", "171026_pose1", num_train_frames),
        ("val", "171026_pose2", num_val_frames),
    ):
        skels = _skeleton_walk(rng, n_frames, num_joints, scale=18.0)
        labels[split_name][pose_name] = {
            "cameras": cameras,
        }
        boxes[split_name][pose_name] = {}
        split[split_name][pose_name] = [[0, n_frames * sample_rate]]
        for i, skel in enumerate(skels):
            frame_id = i * sample_rate
            # schema: [4, K] rows x, y, z, confidence
            labels[split_name][pose_name][str(frame_id)] = np.vstack(
                [skel.T, np.ones((1, num_joints))]
            ).tolist()
            boxes[split_name][pose_name][str(frame_id)] = {}
            for cam_name in cam_names:
                cam = geometry.Camera(
                    cameras[cam_name]["R"],
                    cameras[cam_name]["t"],
                    cameras[cam_name]["K"],
                    cameras[cam_name]["dist"],
                )
                kp2d = cam.project(skel)
                left, top = kp2d.min(axis=0) - 12
                right, bottom = kp2d.max(axis=0) + 12
                boxes[split_name][pose_name][str(frame_id)][cam_name] = [
                    int(left),
                    int(top),
                    int(right),
                    int(bottom),
                ]
                img_dir = os.path.join(root, pose_name, "hdImgs", cam_name)
                os.makedirs(img_dir, exist_ok=True)
                img = _render_view(kp2d, rng, cam_index=cam_names.index(cam_name))
                Image.fromarray(img).save(
                    os.path.join(img_dir, "%s_%08d.jpg" % (cam_name, frame_id)),
                    quality=image_quality,
                )
    # test split reuses val poses (labels for test live under "val",
    # panoptic_dataset.py:31)
    split["test"] = dict(split["val"])

    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump(labels, f)
    with open(os.path.join(root, "boxes.json"), "w") as f:
        json.dump(boxes, f)
    with open(os.path.join(root, "split.json"), "w") as f:
        json.dump(split, f)
    return root


def _chain_bones(num_joints: int):
    """Fixed bone topology: a joint chain plus one cross-link, so every
    joint has at least one attached bone."""
    return [(i, i + 1) for i in range(num_joints - 1)] + [
        (0, (2 * num_joints) // 3)
    ]


def generate_heterogeneous_tree(
    root: str,
    num_common: int = 80,
    num_hard: int = 16,
    num_hard_clusters: int = 4,
    num_val_common: int = 10,
    num_val_hard: int = 10,
    num_joints: int = 19,
    num_cameras: int = 4,
    num_distractors: int = 12,
    sample_rate: int = 25,
    seed: int = 0,
    image_quality: int = 90,
) -> str:
    """Panoptic-schema tree with genuinely heterogeneous frame difficulty,
    for end-to-end AL-vs-RANDOM experiments (tools/validate_al_gain.py).

    Every frame renders the skeleton's BONES (wide gray segments) under the
    joint discs, so bone-attachment is a stationary context cue.  Two frame
    populations:

      * COMMON frames (one long correlated random walk around one base
        pose): discs + bones only.  A color-template detector solves them,
        so a model trained on common frames alone takes that shortcut.
      * HARD frames (`num_hard_clusters` separate walks around offset base
        poses): additionally contain `num_distractors` distractor discs per
        view — pointwise identical to real joint discs (same radius, same
        per-joint palette color), placed uniformly inside the crop box,
        detached from the skeleton, INDEPENDENTLY per view.  A shortcut
        detector is confused per view at random, which (a) corrupts
        cross-view consistency (high TRIANGULATION metric), (b) produces
        multi-peak heatmaps (high MPE), and (c) yields scattered
        triangulated poses (CORESET diversity).  The confusion is
        epistemic, not aleatoric: a model trained WITH hard frames learns
        to require bone attachment and resolves every view.

    The val/test split mixes held-out common-style and hard-style walks so
    the learning curve reflects both.  A `meta.json` sidecar at the tree
    root records the hard/common train guid lists for selection-rate
    diagnostics.

    Matches the label/boxes/split schemas of
    reference/dataset/panoptic_dataset.py:21-87 like generate_panoptic_tree.
    """
    rng = np.random.default_rng(seed)
    cameras = {
        "00_%02d" % i: _ring_camera(i, num_cameras, radius=170.0, focal=300.0)
        for i in range(num_cameras)
    }
    cam_names = sorted(cameras.keys())
    cam_objs = {
        name: geometry.Camera(
            cameras[name]["R"], cameras[name]["t"], cameras[name]["K"],
            cameras[name]["dist"],
        )
        for name in cam_names
    }
    bones = _chain_bones(num_joints)
    labels: Dict = {"train": {}, "val": {}}
    boxes: Dict = {"train": {}, "val": {}}
    split: Dict = {
        "train": {},
        "val": {},
        "test": {},
        "cameras": {"train": cam_names, "val": cam_names, "test": cam_names},
    }
    meta = {"hard_guids": [], "common_guids": [], "val_hard_guids": []}

    def guid_of(pose_name: str, frame_id: int) -> str:
        return "%s%s-%d" % (pose_name[:6], pose_name[-1], frame_id)

    def write_sequence(split_name, pose_name, skels, hard: bool):
        labels[split_name][pose_name] = {"cameras": cameras}
        boxes[split_name][pose_name] = {}
        split[split_name][pose_name] = [[0, len(skels) * sample_rate]]
        guids = []
        for i, skel in enumerate(skels):
            frame_id = i * sample_rate
            guids.append(guid_of(pose_name, frame_id))
            labels[split_name][pose_name][str(frame_id)] = np.vstack(
                [skel.T, np.ones((1, num_joints))]
            ).tolist()
            boxes[split_name][pose_name][str(frame_id)] = {}
            for cam_name in cam_names:
                kp2d = cam_objs[cam_name].project(skel)
                left, top = kp2d.min(axis=0) - 12
                right, bottom = kp2d.max(axis=0) + 12
                boxes[split_name][pose_name][str(frame_id)][cam_name] = [
                    int(left), int(top), int(right), int(bottom),
                ]
                distractors = []
                if hard:
                    # Uniform inside the crop box, >= 20 px from every real
                    # joint (a distractor overlapping a real disc is
                    # harmless but ugly; near-coincident ones would blunt
                    # the confusion signal).
                    for _ in range(num_distractors):
                        for _try in range(50):
                            dx = rng.uniform(max(left, 0), min(right, FULL_W))
                            dy = rng.uniform(max(top, 0), min(bottom, FULL_H))
                            if np.min(
                                (kp2d[:, 0] - dx) ** 2 + (kp2d[:, 1] - dy) ** 2
                            ) >= 400.0:
                                distractors.append(
                                    (dx, dy, int(rng.integers(num_joints)))
                                )
                                break
                img_dir = os.path.join(root, pose_name, "hdImgs", cam_name)
                os.makedirs(img_dir, exist_ok=True)
                img = _render_view(
                    kp2d,
                    rng,
                    cam_index=cam_names.index(cam_name),
                    bones=bones,
                    distractors=distractors,
                )
                Image.fromarray(img).save(
                    os.path.join(img_dir, "%s_%08d.jpg" % (cam_name, frame_id)),
                    quality=image_quality,
                )
        return guids

    def interleave(walk, n_val):
        """Split one walk into train/val frame lists with the val frames
        evenly INTERLEAVED: val poses sit inside the convex hull of the
        train poses of the same scene, so val measures within-scene
        generalization (new frames of a scene the model has labeled data
        from — the realistic AL deployment setting), not transfer to an
        unseen pose region (which the tiny-budget models of this
        experiment cannot do, making every selection strategy look
        equally bad)."""
        n = len(walk)
        val_idx = set(
            int(i) for i in np.linspace(1, n - 2, num=n_val).round()
        ) if n_val else set()
        train_frames = [w for i, w in enumerate(walk) if i not in val_idx]
        val_frames = [w for i, w in enumerate(walk) if i in val_idx]
        return train_frames, val_frames

    # One correlated common walk + several offset hard-cluster walks; val
    # frames interleave each walk.
    common_base = rng.normal(scale=18.0, size=(num_joints, 3))
    common_train, common_val = interleave(
        _walk_from_base(rng, common_base, num_common + num_val_common),
        num_val_common,
    )
    meta["common_guids"] = write_sequence(
        "train", "500000_pose0", common_train, hard=False
    )
    write_sequence("val", "700000_pose0", common_val, hard=False)

    per_cluster = max(num_hard // max(num_hard_clusters, 1), 1)
    val_per_cluster = num_val_hard // max(num_hard_clusters, 1)
    for c in range(num_hard_clusters):
        base = (
            rng.normal(scale=18.0, size=(num_joints, 3))
            + rng.normal(scale=25.0, size=(1, 3))
        )
        n = per_cluster if c < num_hard_clusters - 1 else (
            num_hard - per_cluster * (num_hard_clusters - 1)
        )
        nv = val_per_cluster if c < num_hard_clusters - 1 else (
            num_val_hard - val_per_cluster * (num_hard_clusters - 1)
        )
        hard_train, hard_val = interleave(
            _walk_from_base(rng, base, n + nv), nv
        )
        meta["hard_guids"] += write_sequence(
            "train", "6000%02d_pose0" % c, hard_train, hard=True
        )
        meta["val_hard_guids"] += write_sequence(
            "val", "7100%02d_pose0" % c, hard_val, hard=True
        )
    split["test"] = dict(split["val"])

    with open(os.path.join(root, "labels.json"), "w") as f:
        json.dump(labels, f)
    with open(os.path.join(root, "boxes.json"), "w") as f:
        json.dump(boxes, f)
    with open(os.path.join(root, "split.json"), "w") as f:
        json.dump(split, f)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    return root


def _walk_from_base(rng, base: np.ndarray, num_frames: int):
    """Correlated random walk around a GIVEN base skeleton (the
    _skeleton_walk dynamics with an explicit anchor)."""
    frames = []
    cur = base
    for _ in range(num_frames):
        cur = 0.9 * cur + 0.1 * base + rng.normal(
            scale=18.0 * 0.08, size=cur.shape
        )
        frames.append(cur.copy())
    return frames


def generate_ih26m_tree(
    root: str,
    num_frames: int = 6,
    num_joints: int = 42,
    num_cameras: int = 4,
    seed: int = 0,
) -> str:
    """Miniature InterHand2.6M-schema tree (annotations/<split>/*.json +
    images/<split>/...), matching the fields read at
    dataset/ih26m_dataset.py:19-119."""
    rng = np.random.default_rng(seed)
    cam_names = ["cam%02d" % i for i in range(num_cameras)]
    for split_name in ("train", "val", "test"):
        camrot, campos, focal, princpt = {}, {}, {}, {}
        cams = {}
        for i, name in enumerate(cam_names):
            c = _ring_camera(i, num_cameras, radius=170.0, focal=300.0)
            R = np.asarray(c["R"])
            t = np.asarray(c["t"])
            camrot[name] = R.tolist()
            campos[name] = (-R.T @ t).tolist()
            focal[name] = [c["K"][0][0], c["K"][1][1]]
            princpt[name] = [c["K"][0][2], c["K"][1][2]]
            cams[name] = c
        camera_json = {"0": {"camrot": camrot, "campos": campos,
                             "focal": focal, "princpt": princpt}}
        skels = _skeleton_walk(rng, num_frames, num_joints, scale=18.0)
        images: List[Dict] = []
        annotations: List[Dict] = []
        joint_3d: Dict = {"0": {}}
        for i, skel in enumerate(skels):
            joint_3d["0"][str(i)] = {
                "world_coord": skel.tolist(),
                "joint_valid": [[1.0]] * num_joints,
                "hand_type": "interacting",
            }
            for name in cam_names:
                cam = geometry.Camera(cams[name]["R"], cams[name]["t"], cams[name]["K"])
                kp2d = cam.project(skel)
                left, top = kp2d.min(axis=0) - 12
                right, bottom = kp2d.max(axis=0) + 12
                file_name = "img_%d_%s.jpg" % (i, name)
                img_path = os.path.join(root, "images", split_name, file_name)
                os.makedirs(os.path.dirname(img_path), exist_ok=True)
                Image.fromarray(
                    _render_view(kp2d, rng, cam_index=cam_names.index(name))
                ).save(img_path, quality=90)
                images.append(
                    {
                        "capture": 0,
                        "frame_idx": i,
                        "camera": name,
                        "file_name": file_name,
                    }
                )
                annotations.append(
                    {
                        "bbox": [
                            float(left),
                            float(top),
                            float(right - left),
                            float(bottom - top),
                        ],
                        "joint_valid": [[1.0]] * num_joints,
                    }
                )
        ann_dir = os.path.join(root, "annotations", split_name)
        os.makedirs(ann_dir, exist_ok=True)
        with open(
            os.path.join(ann_dir, "InterHand2.6M_%s_camera.json" % split_name), "w"
        ) as f:
            json.dump(camera_json, f)
        with open(
            os.path.join(ann_dir, "InterHand2.6M_%s_data.json" % split_name), "w"
        ) as f:
            json.dump({"images": images, "annotations": annotations}, f)
        with open(
            os.path.join(ann_dir, "InterHand2.6M_%s_joint_3d.json" % split_name), "w"
        ) as f:
            json.dump(joint_3d, f)
    return root
