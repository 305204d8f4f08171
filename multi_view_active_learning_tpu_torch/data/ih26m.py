"""InterHand2.6M dataset indexer (the port's own copy of the JAX package's
data/ih26m.py).

Reads the three per-split annotation JSONs exactly as the reference
(dataset/ih26m_dataset.py:16-184): camera (focal/princpt/camrot/campos),
data (images + annotations), joint_3d (world_coord / joint_valid /
hand_type).  Capture-range filtering, hand-type validity filtering, camera
intrinsics construction (t = R @ (-campos)) and the common-camera selection
all follow the reference.

Fixed here (SURVEY.md §"known quirks"): the reference's farthest-point
camera selection never updates its running distances
(ih26m_utils/ih26m_common_cams.py:47, bare statement), degenerating to
"last iterated camera".  `select_common_cameras` implements the intended
greedy max-min spread.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np

from ..utils import get_logger
from ..utils import storage
from .pools import FramePool


def select_common_cameras(
    all_cam: Dict, captures: Sequence, num_cams: int,
    reference_compat: bool = False,
) -> List[str]:
    """Greedy farthest-point selection over cameras common to all captures.

    Reference intent: ih26m_utils/ih26m_common_cams.py:16-95 (with the
    min-distance update bug fixed).

    reference_compat=True reproduces the reference's *actual* behavior:
    its `nearest_dis` update at ih26m_common_cams.py:47 is a bare no-op
    statement, so `nearest_dis` stays inf and `inf > furthurest_dis` only
    fires for the first candidate — each greedy round picks the first
    remaining camera in iteration order.  Net effect: the first `num_cams`
    common cameras, in capture-0 JSON key order (not sorted).  Parity runs
    against reference checkpoints must use this mode so the dataset contains
    the identical views."""
    captures = [str(c) for c in captures]
    captures = [c for c in captures if c in all_cam]
    if reference_compat:
        # Preserve the reference's ordering: capture-0 insertion order,
        # filtered down to cameras present in every capture.
        common = list(all_cam[captures[0]]["campos"].keys())
        for cap in captures:
            names = all_cam[cap]["campos"].keys()
            common = [c for c in common if c in names]
        if num_cams == -1:
            return common
        if num_cams > len(common):
            raise ArithmeticError(
                "Not enough common cameras among the selected captures."
            )
        return common[:num_cams]
    common = None
    for cap in captures:
        names = set(all_cam[cap]["campos"].keys())
        common = names if common is None else (common & names)
    common = sorted(common or [])
    if len(common) <= num_cams:
        return common
    pos = np.stack(
        [np.asarray(all_cam[captures[0]]["campos"][c], dtype=np.float64) for c in common]
    )
    selected = [0]
    min_dist = np.linalg.norm(pos - pos[0], axis=-1)
    for _ in range(num_cams - 1):
        nxt = int(np.argmax(min_dist))
        selected.append(nxt)
        min_dist = np.minimum(min_dist, np.linalg.norm(pos - pos[nxt], axis=-1))
    return [common[i] for i in sorted(selected)]


class InterHand26MDataset(FramePool):
    NUM_JOINTS_DEFAULT = 42

    def __init__(self, data_cfg, gt_stride, split="val", root: str = ""):
        super().__init__(split=split)
        self.data_cfg = data_cfg
        self.gt_stride = gt_stride
        self._logger = get_logger(__name__)
        home = root or data_cfg.IH26M.HOME
        ann = storage.join(home, "annotations", split)
        with storage.open_file(
            storage.join(ann, "InterHand2.6M_%s_camera.json" % split)
        ) as f:
            self.all_cam = json.load(f)
        with storage.open_file(
            storage.join(ann, "InterHand2.6M_%s_data.json" % split)
        ) as f:
            data = json.load(f)
        with storage.open_file(
            storage.join(ann, "InterHand2.6M_%s_joint_3d.json" % split)
        ) as f:
            joints = json.load(f)

        cap_range = (
            range(*data_cfg.IH26M.CAPTURE_RANGE)
            if split == "train"
            else range(*data_cfg.IH26M.TEST_CAPTURE_RANGE)
            if split == "test"
            else None
        )
        num_joints = data_cfg.NUM_JOINTS

        for meta, annotation in zip(data["images"], data["annotations"]):
            capture = str(meta["capture"])
            if cap_range is not None and int(capture) not in cap_range:
                continue
            frame_id = str(meta["frame_idx"])
            guid = "%s-%s" % (capture, frame_id)
            ih_joint = joints[capture][frame_id]
            world = np.asarray(ih_joint["world_coord"], dtype=np.float64)
            if len(world) != num_joints:
                self._logger.warning(
                    "Frame does not have the expected joints: %s" % guid
                )
                continue
            if self._filter_view(ih_joint, annotation):
                continue
            left, top, width, height = annotation["bbox"]
            view = {
                "camera": self._get_camera(capture, meta["camera"]),
                "path": storage.join(home, "images", split, meta["file_name"]),
                "box": (left, top, left + width, top + height),
                "camera_name": meta["camera"],
                "per_view_joint_valid": np.asarray(
                    annotation["joint_valid"], dtype=np.float64
                ).reshape(-1).astype(bool),
            }
            if guid in self.unlabeled_data:
                if meta["camera"] in self.unlabeled_data[guid]["views"]:
                    self._logger.warning(
                        "Duplicate camera (%s) in GUID %s." % (meta["camera"], guid)
                    )
                self.unlabeled_data[guid]["views"][meta["camera"]] = view
            else:
                self.unlabeled_data[guid] = {
                    "views": OrderedDict({meta["camera"]: view}),
                    "3d_keypoints": world,  # [K, 3]
                    "joint_valid": np.asarray(ih_joint["joint_valid"], dtype=np.float64)
                    .reshape(-1)
                    .astype(bool),
                    "hand_type": ih_joint["hand_type"],
                    "pose": int(capture),
                    "frame_id": int(frame_id),
                    "guid": guid,
                }

        self.list_of_cameras = self._select_cameras(split)
        for guid in list(self.unlabeled_data.keys()):
            views = self.unlabeled_data[guid]["views"]
            kept = OrderedDict(
                (cam, views[cam]) for cam in self.list_of_cameras if cam in views
            )
            if len(kept) != len(self.list_of_cameras):
                self._logger.warning(
                    "Frame %s does not have %d views."
                    % (guid, len(self.list_of_cameras))
                )
                del self.unlabeled_data[guid]
            else:
                self.unlabeled_data[guid]["views"] = kept
        self._logger.info(
            "IH26M %s: %d frames x %d views."
            % (split, len(self.unlabeled_data), len(self.list_of_cameras))
        )

    @staticmethod
    def _filter_view(ih_joint, annotation) -> bool:
        """Drop frames whose active hand has invalid joints in both the 3D GT
        and the per-view annotation (reference: ih26m_dataset.py:121-140)."""
        jv = np.asarray(ih_joint["joint_valid"]).reshape(-1)
        av = np.asarray(annotation["joint_valid"]).reshape(-1)
        ht = ih_joint["hand_type"]
        if ht == "right" and not jv[:21].all() and not av[:21].all():
            return True
        if ht == "left" and not jv[21:].all() and not av[21:].all():
            return True
        if ht == "interacting" and not jv.all() and not av.all():
            return True
        return False

    def _get_camera(self, capture: str, camera_name: str) -> Dict:
        """K from focal/princpt; t = R @ (-campos)
        (reference: ih26m_dataset.py:173-184)."""
        cam = self.all_cam[capture]
        R = np.asarray(cam["camrot"][camera_name], dtype=np.float64)
        t = R @ (-np.asarray(cam["campos"][camera_name], dtype=np.float64))
        f = np.asarray(cam["focal"][camera_name], dtype=np.float64)
        p = np.asarray(cam["princpt"][camera_name], dtype=np.float64)
        K = np.diag([f[0], f[1], 1.0])
        K[0, 2], K[1, 2] = p[0], p[1]
        return {"R": R, "t": t, "K": K, "dist": None}

    def _select_cameras(self, split: str) -> List[str]:
        if split == "train":
            caps = list(range(*self.data_cfg.IH26M.CAPTURE_RANGE))
            n = self.data_cfg.IH26M.NUM_VIEW_PER_FRAME
        elif split == "val":
            caps = ["0"]
            n = self.data_cfg.IH26M.NUM_VIEW_PER_FRAME
        else:
            caps = list(range(*self.data_cfg.IH26M.TEST_CAPTURE_RANGE))
            n = self.data_cfg.IH26M.TEST_NUM_VIEW_PER_FRAME
        return select_common_cameras(
            self.all_cam, caps, n,
            reference_compat=self.data_cfg.IH26M.REFERENCE_COMPAT_CAMS,
        )

    def get_num_view_per_frame(self) -> int:
        return len(self.list_of_cameras)
