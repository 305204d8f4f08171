#!/usr/bin/env python3
"""Fail-fast validator for user-supplied real dataset trees, on the PyTorch
port: the counterpart of tools/check_dataset.py, the same checks and
output, with the port's data layer (``data/ih26m.py``'s common-camera
selection, ``data.build_dataset`` for ``--build``).  Imports nothing of
JAX.

Checks a CMU Panoptic tree (the JSON schemas read by
reference/dataset/panoptic_dataset.py:21-87 — aggregated labels, GT boxes,
train/val split) or an InterHand2.6M tree (the three per-split annotation
JSONs read by reference/dataset/ih26m_dataset.py:19-119) BEFORE a parity or
training run, so schema problems surface in seconds instead of deep inside
an experiment:

  * all JSON artifacts load and have the expected top-level structure;
  * camera parameters have the right shapes (R 3x3, t 3, K 3x3, dist 5 /
    camrot-campos-focal-princpt alignment);
  * skeleton schema ([4, K] rows for Panoptic; world_coord length K for
    IH26M) and a consistent joint count across frames;
  * GT-box coverage per camera (frames the indexer would drop);
  * guid uniqueness (Panoptic guids truncate pose names — two pose
    sequences can silently collide);
  * a decoded-sample smoke: opens real images, checks the crop boxes
    against the image bounds;
  * optionally (--build) runs the real indexer over the tree.

Usage:
  python tools/check_dataset_torch.py --type panoptic --root /data/panoptic
  python tools/check_dataset_torch.py --type panoptic \
      --labels labels.json --boxes boxes.json --split split.json --home ...
  python tools/check_dataset_torch.py --type ih26m --root /data/ih26m
"""

import argparse
import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


class Report:
    def __init__(self):
        self.errors = []
        self.warnings = []

    def error(self, msg):
        self.errors.append(msg)
        print("ERROR: %s" % msg)

    def warn(self, msg):
        self.warnings.append(msg)
        print("warning: %s" % msg)

    def ok(self, msg):
        print("ok: %s" % msg)

    def finish(self) -> int:
        print(
            "\n%d error(s), %d warning(s): %s"
            % (
                len(self.errors),
                len(self.warnings),
                "FAILED — fix before running experiments"
                if self.errors
                else "tree looks usable",
            )
        )
        return 1 if self.errors else 0


def _load_json(rep, path, what):
    if not os.path.exists(path):
        rep.error("%s not found at %s" % (what, path))
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except Exception as ex:
        rep.error("%s failed to parse: %s" % (what, ex))
        return None


def _check_camera(rep, cam, where):
    try:
        R = np.asarray(cam["R"], np.float64)
        t = np.asarray(cam["t"], np.float64)
        K = np.asarray(cam["K"], np.float64)
        dist = np.asarray(cam.get("dist", [0] * 5), np.float64)
    except Exception as ex:
        rep.error("%s: camera fields unreadable (%s)" % (where, ex))
        return
    if R.shape != (3, 3):
        rep.error("%s: R shape %s != (3, 3)" % (where, R.shape))
    if t.reshape(-1).shape[0] != 3:
        rep.error("%s: t has %d elements != 3" % (where, t.size))
    if K.shape != (3, 3):
        rep.error("%s: K shape %s != (3, 3)" % (where, K.shape))
    if dist.reshape(-1).shape[0] < 5:
        rep.warn("%s: dist has %d coefficients (< 5)" % (where, dist.size))
    if abs(np.linalg.det(R)) < 0.5:
        rep.warn("%s: R determinant %.3f — not a rotation?" % (where, np.linalg.det(R)))


def check_panoptic(args) -> int:
    rep = Report()
    root = args.root
    labels_path = args.labels or os.path.join(root, "labels.json")
    boxes_path = args.boxes or os.path.join(root, "boxes.json")
    split_path = args.split or os.path.join(root, "split.json")
    home = args.home or root

    labels = _load_json(rep, labels_path, "labels.json")
    boxes = _load_json(rep, boxes_path, "boxes.json")
    split = _load_json(rep, split_path, "split.json")
    if labels is None or boxes is None or split is None:
        return rep.finish()

    for s in ("train", "val", "test"):
        if s not in split:
            rep.error("split.json missing split %r" % s)
    if "cameras" not in split:
        rep.error("split.json missing the per-split 'cameras' lists")
        return rep.finish()
    for s in ("train", "val", "test"):
        cams = split["cameras"].get(s, [])
        if not cams:
            rep.error("split.json cameras[%r] is empty" % s)
        else:
            rep.ok("%s: %d cameras" % (s, len(cams)))

    joint_counts = Counter()
    smoke_done = False
    for s in ("train", "val", "test"):
        label_split = "val" if s == "test" else s  # panoptic_dataset.py:31
        cams = split["cameras"].get(s, [])
        guids = set()
        n_frames = n_missing_label = n_missing_box = 0
        for pose in split.get(s, {}):
            if pose not in labels.get(label_split, {}):
                rep.error(
                    "split %s pose %r has no labels under labels[%r]"
                    % (s, pose, label_split)
                )
                continue
            pose_labels = labels[label_split][pose]
            if "cameras" not in pose_labels:
                rep.error("labels[%r][%r] missing 'cameras'" % (label_split, pose))
                continue
            for cam_name in cams:
                if cam_name not in pose_labels["cameras"]:
                    rep.error(
                        "pose %r: split camera %r absent from its camera dict"
                        % (pose, cam_name)
                    )
                else:
                    _check_camera(
                        rep, pose_labels["cameras"][cam_name],
                        "%s/%s/%s" % (s, pose, cam_name),
                    )
            pose_boxes = boxes.get(label_split, {}).get(pose, {})
            for section in split[s][pose]:
                if not (isinstance(section, list) and len(section) == 2):
                    rep.error("split %s pose %r: bad section %r" % (s, pose, section))
                    continue
                for frame_id in range(section[0], section[1], args.sample_rate):
                    fid = str(frame_id)
                    n_frames += 1
                    if fid not in pose_labels:
                        n_missing_label += 1
                        continue
                    skel = np.asarray(pose_labels[fid], np.float64)
                    if skel.ndim != 2 or skel.shape[0] != 4:
                        rep.error(
                            "pose %r frame %s: skeleton shape %s != [4, K]"
                            % (pose, fid, skel.shape)
                        )
                    else:
                        joint_counts[skel.shape[1]] += 1
                    frame_boxes = pose_boxes.get(fid, {})
                    if any(c not in frame_boxes for c in cams):
                        n_missing_box += 1
                        continue
                    guid = "%s%s-%d" % (pose[:6], pose[-1], frame_id)
                    if guid in guids:
                        rep.error(
                            "guid collision: %r (pose names %r... share the "
                            "first-6-chars + last-char truncation)" % (guid, pose)
                        )
                    guids.add(guid)
                    if not smoke_done:
                        smoke_done = _smoke_image(
                            rep,
                            os.path.join(
                                home, pose, "hdImgs", cams[0],
                                "%s_%08d.jpg" % (cams[0], frame_id),
                            ),
                            frame_boxes[cams[0]],
                        )
        usable = len(guids)
        rep.ok(
            "%s: %d indexed frames usable (%d strided positions, "
            "%d without labels, %d dropped for missing boxes)"
            % (s, usable, n_frames, n_missing_label, n_missing_box)
        )
        if usable == 0:
            rep.error("split %s has no usable frames" % s)
        if n_frames and n_missing_box / max(n_frames, 1) > 0.25:
            rep.warn(
                "%s: >25%% of frames lack full GT-box coverage — run "
                "data/prep.py::compute_gt_boxes?" % s
            )
    if len(joint_counts) > 1:
        rep.error("inconsistent joint counts across frames: %s" % dict(joint_counts))
    elif joint_counts:
        k = next(iter(joint_counts))
        rep.ok("joint count K=%d (set DATA.NUM_JOINTS: %d)" % (k, k))

    if args.build and not rep.errors:
        _build_smoke(rep, args, "panoptic", root, labels_path, boxes_path, split_path)
    return rep.finish()


def _smoke_image(rep, path, box) -> bool:
    """Open one real image and sanity-check the crop box.  Returns True if
    the smoke ran (found the file), False to try the next frame."""
    from PIL import Image

    if not os.path.exists(path):
        rep.warn("decoded-sample smoke: image not found at %s" % path)
        return False
    try:
        img = Image.open(path)
        img.load()
    except Exception as ex:
        rep.error("decoded-sample smoke: %s failed to decode (%s)" % (path, ex))
        return True
    w, h = img.size
    rep.ok("decoded-sample smoke: %s (%dx%d, mode %s)" % (path, w, h, img.mode))
    left, top, right, bottom = box[:4]
    if right <= left or bottom <= top:
        rep.error("degenerate GT box %r for %s" % (box, path))
    if left >= w or top >= h or right <= 0 or bottom <= 0:
        rep.error("GT box %r lies fully outside the %dx%d image" % (box, w, h))
    return True


def check_ih26m(args) -> int:
    rep = Report()
    root = args.root
    for s in ("train", "val", "test"):
        ann = os.path.join(root, "annotations", s)
        cam = _load_json(
            rep, os.path.join(ann, "InterHand2.6M_%s_camera.json" % s),
            "%s camera json" % s,
        )
        data = _load_json(
            rep, os.path.join(ann, "InterHand2.6M_%s_data.json" % s),
            "%s data json" % s,
        )
        joints = _load_json(
            rep, os.path.join(ann, "InterHand2.6M_%s_joint_3d.json" % s),
            "%s joint_3d json" % s,
        )
        if cam is None or data is None or joints is None:
            continue
        for cap, c in cam.items():
            for key in ("camrot", "campos", "focal", "princpt"):
                if key not in c:
                    rep.error("%s capture %s camera json missing %r" % (s, cap, key))
            names = set(c.get("campos", {}))
            for key in ("camrot", "focal", "princpt"):
                if set(c.get(key, {})) != names:
                    rep.error(
                        "%s capture %s: %r cameras differ from campos" % (s, cap, key)
                    )
            for name in names:
                R = np.asarray(c["camrot"][name], np.float64)
                if R.shape != (3, 3):
                    rep.error("%s capture %s cam %s: camrot %s" % (s, cap, name, R.shape))
                if len(c["focal"][name]) != 2 or len(c["princpt"][name]) != 2:
                    rep.error("%s capture %s cam %s: focal/princpt not length-2"
                              % (s, cap, name))
        if len(data.get("images", [])) != len(data.get("annotations", [])):
            rep.error(
                "%s: images (%d) and annotations (%d) misaligned"
                % (s, len(data.get("images", [])), len(data.get("annotations", [])))
            )
        joint_counts = Counter()
        smoke_done = False
        n_ok = 0
        for meta, annotation in zip(data["images"], data["annotations"]):
            cap = str(meta.get("capture"))
            fid = str(meta.get("frame_idx"))
            if cap not in joints or fid not in joints.get(cap, {}):
                rep.warn("%s: %s-%s has no joint_3d entry" % (s, cap, fid))
                continue
            entry = joints[cap][fid]
            for key in ("world_coord", "joint_valid", "hand_type"):
                if key not in entry:
                    rep.error("%s: joint_3d %s-%s missing %r" % (s, cap, fid, key))
            joint_counts[len(entry.get("world_coord", []))] += 1
            bbox = annotation.get("bbox")
            if not (isinstance(bbox, list) and len(bbox) == 4):
                rep.error("%s: %s-%s bad bbox %r" % (s, cap, fid, bbox))
            n_ok += 1
            if not smoke_done:
                img_path = os.path.join(root, "images", s, meta.get("file_name", ""))
                left, top, bw, bh = bbox
                smoke_done = _smoke_image(
                    rep, img_path, [left, top, left + bw, top + bh]
                )
        rep.ok("%s: %d frames with aligned annotations" % (s, n_ok))
        if len(joint_counts) > 1:
            rep.warn(
                "%s: multiple joint counts %s (frames with the wrong count "
                "are dropped by the indexer)" % (s, dict(joint_counts))
            )
        # Common-camera viability for the configured view counts.
        from multi_view_active_learning_tpu_torch.data.ih26m import select_common_cameras

        caps = sorted(cam.keys(), key=lambda x: int(x))[:2]
        try:
            picked = select_common_cameras(cam, caps, min(args.num_views, 4))
            rep.ok("%s: common-camera selection works (%s...)" % (s, picked[:2]))
        except Exception as ex:
            rep.error("%s: common-camera selection failed: %s" % (s, ex))

    if args.build and not rep.errors:
        _build_smoke(rep, args, "ih26m", root, None, None, None)
    return rep.finish()


def _build_smoke(rep, args, dtype, root, labels, boxes, split):
    """Run the port's indexer over the tree."""
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.data import build_dataset

    cfg = get_default_configs()
    cfg.DATA.TYPE = dtype
    if dtype == "panoptic":
        cfg.DATA.PANOPTIC.HOME = args.home or root
        cfg.DATA.PANOPTIC.LABEL_PATH = labels
        cfg.DATA.PANOPTIC.GT_BOXES = boxes
        cfg.DATA.PANOPTIC.TRAIN_VAL_SPLIT = split
        cfg.DATA.PANOPTIC.SAMPLE_RATE = args.sample_rate
    else:
        cfg.DATA.IH26M.HOME = root
        cfg.DATA.NUM_JOINTS = 42
    for s in ("train", "val"):
        try:
            ds = build_dataset(cfg, s)
            rep.ok(
                "indexer build %s: %d frames x %d views"
                % (s, len(ds.unlabeled_data), ds.get_num_view_per_frame())
            )
            if not ds.unlabeled_data:
                rep.error("indexer produced an empty %s pool" % s)
        except Exception as ex:
            rep.error("indexer build %s raised: %s" % (s, ex))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--type", choices=("panoptic", "ih26m"), required=True)
    parser.add_argument("--root", default="", help="tree root directory")
    parser.add_argument("--home", default="", help="image home (panoptic; defaults to --root)")
    parser.add_argument("--labels", default="", help="labels.json path override")
    parser.add_argument("--boxes", default="", help="boxes.json path override")
    parser.add_argument("--split", default="", help="split.json path override")
    parser.add_argument("--sample_rate", type=int, default=25)
    parser.add_argument("--num_views", type=int, default=16)
    parser.add_argument(
        "--build", action="store_true",
        help="also run the port's indexer over the tree",
    )
    args = parser.parse_args(argv)
    if not args.root and not (args.labels and args.boxes and args.split):
        parser.error("--root (or explicit --labels/--boxes/--split) required")
    if args.type == "panoptic":
        return check_panoptic(args)
    return check_ih26m(args)


if __name__ == "__main__":
    sys.exit(main())
