"""CMU Panoptic dataset indexer (the port's own copy of the JAX package's
data/panoptic.py).

Reads the same three JSON artifacts as the reference
(dataset/panoptic_dataset.py:16-87): aggregated labels
(`{split: {pose: {frame_id: [4, 19] skeleton, "cameras": {...}}}}`,
schema from dataset/panoptic_utils/aggregate_labels.py:19-52), GT boxes,
and the train/val split with per-split camera lists.  Frame guids are
``f"{pose[:6]}{pose[-1]}-{frame_id}"`` (panoptic_dataset.py:67).

Differences from the reference: utils/storage paths (local fast path,
fsspec for gs://-style URIs) instead of manifold URIs; 3D keypoints are
normalized to [K, 3] float64 at load (the reference keeps the raw [4, K]
rows and re-transposes at every use).
"""

from __future__ import annotations

import json
from collections import OrderedDict

import numpy as np

from ..utils import get_logger
from ..utils import storage
from .pools import FramePool


class CMUPanopticDataset(FramePool):
    NUM_JOINTS_DEFAULT = 19

    def __init__(self, data_cfg, gt_stride, split="val", root: str = ""):
        super().__init__(split=split)
        self.data_cfg = data_cfg
        self.gt_stride = gt_stride
        self._logger = get_logger(__name__)

        home = root or data_cfg.PANOPTIC.HOME
        label_path = (
            storage.join(root, "labels.json")
            if root
            else data_cfg.PANOPTIC.LABEL_PATH
        )
        boxes_path = (
            storage.join(root, "boxes.json")
            if root
            else data_cfg.PANOPTIC.GT_BOXES
        )
        split_path = (
            storage.join(root, "split.json")
            if root
            else data_cfg.PANOPTIC.TRAIN_VAL_SPLIT
        )
        with storage.open_file(label_path) as f:
            labels = json.load(f)
        with storage.open_file(boxes_path) as f:
            boxes = json.load(f)
        with storage.open_file(split_path) as f:
            self.train_val_split = json.load(f)
        self.list_of_cameras = list(self.train_val_split["cameras"][self.split])

        # Labels for the test split are stored under "val"
        # (panoptic_dataset.py:31).
        label_split = "val" if self.split == "test" else self.split
        num_joints = data_cfg.NUM_JOINTS
        for pose in self.train_val_split[self.split]:
            cameras = labels[label_split][pose]["cameras"]
            for section in self.train_val_split[self.split][pose]:
                for frame_id in range(
                    section[0], section[1], data_cfg.PANOPTIC.SAMPLE_RATE
                ):
                    fid = str(frame_id)
                    if fid not in labels[label_split][pose]:
                        continue
                    guid = "%s%s-%d" % (pose[:6], pose[-1], frame_id)
                    if guid in self.unlabeled_data:
                        self._logger.warning("Duplicate GUID: %s." % guid)
                        continue
                    frame_boxes = boxes[label_split][pose].get(fid, {})
                    if any(c not in frame_boxes for c in self.list_of_cameras):
                        self._logger.warning(
                            "GT Box not found for %s-%d" % (pose, frame_id)
                        )
                        continue
                    views = OrderedDict()
                    for camera_name in self.list_of_cameras:
                        views[camera_name] = {
                            "camera": cameras[camera_name],
                            "path": storage.join(
                                home,
                                pose,
                                "hdImgs",
                                camera_name,
                                "%s_%08d.jpg" % (camera_name, frame_id),
                            ),
                            "box": frame_boxes[camera_name],
                            "camera_name": camera_name,
                            "per_view_joint_valid": np.ones(num_joints, bool),
                        }
                    skel = np.asarray(
                        labels[label_split][pose][fid], dtype=np.float64
                    )  # [4, K] rows: x, y, z, confidence
                    self.unlabeled_data[guid] = {
                        "views": views,
                        "3d_keypoints": skel[:3, :].T,  # [K, 3]
                        "joint_valid": np.ones(num_joints, bool),
                        "pose": int(guid.split("-")[0]),
                        "frame_id": frame_id,
                        "guid": guid,
                    }
        self._logger.info(
            "Panoptic %s: %d frames x %d views."
            % (split, len(self.unlabeled_data), len(self.list_of_cameras))
        )

    def get_num_view_per_frame(self) -> int:
        return len(self.list_of_cameras)
