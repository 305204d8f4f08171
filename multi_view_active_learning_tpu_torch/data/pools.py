"""Active-learning frame pools (the port's own copy of the JAX package's
data/pools.py).

The reference couples pool bookkeeping to torch.utils.data.Dataset
(dataset/dataset.py:25-110).  Here the pool is a plain container of frame
metadata; batching/IO live in pipeline.py.  Semantics are identical:

  * unlabeled_data: OrderedDict guid -> frame (insertion-ordered),
  * labeled_data / pseudo_labeled_data lists,
  * label_by_frame_guids moves frames unlabeled -> labeled,
  * pseudo_label_by_frame_guids copies frames with attached pseudo 3D
    keypoints (replacing GT for heatmap synthesis),
  * resample_frames(-1, epoch_size) duplicates labeled+pseudo data to at
    least epoch_size and shuffles (dataset/dataset.py:76-96),
  * resample_unlabeled_data() exposes the unlabeled pool for scoring.

All randomness flows through an explicit numpy Generator instead of the
reference's global `random` module, so experiments replay deterministically.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

import numpy as np


class FramePool:
    def __init__(self, frames: Optional[Dict[str, dict]] = None, split: str = "train"):
        if split not in ("train", "val", "test"):
            raise ValueError("split must be train/val/test, got %s" % split)
        self.split = split
        self.unlabeled_data: "OrderedDict[str, dict]" = OrderedDict(frames or {})
        self.labeled_data: List[dict] = []
        self.pseudo_labeled_data: List[dict] = []
        self.pseudo_label_guids: List[str] = []
        self.data: List[dict] = []

    # -- labeling ops (reference: dataset/dataset.py:56-74) -----------------

    def label_all(self) -> None:
        for guid in self.unlabeled_data:
            self.labeled_data.append(self.unlabeled_data[guid])
        self.unlabeled_data = OrderedDict()

    def label_by_frame_guids(self, guids: Iterable[str]) -> None:
        for guid in guids:
            self.labeled_data.append(self.unlabeled_data[guid])
            del self.unlabeled_data[guid]

    def pseudo_label_by_frame_guids(self, guids: List[str], pseudo_labels) -> None:
        """pseudo_labels: {guid: [K, 3] keypoints} (SAL-DICT format)."""
        self.pseudo_label_guids = list(guids)
        self.pseudo_labeled_data = []
        for guid in guids:
            frame = dict(self.unlabeled_data[guid])
            frame["pseudo_3d_keypoints"] = np.asarray(
                pseudo_labels[guid], dtype=np.float64
            )
            self.pseudo_labeled_data.append(frame)

    # -- epoch views (reference: dataset/dataset.py:76-102) -----------------

    def resample_frames(
        self, num_frames: int = -1, epoch_size: int = 0, rng=None
    ) -> None:
        rng = rng or np.random.default_rng(0)
        if num_frames == -1:
            base = list(self.labeled_data) + list(self.pseudo_labeled_data)
            self.data = list(base)
            if self.split == "train" and base:
                copies = epoch_size // len(base)
                for _ in range(copies):
                    self.data += list(base)
            perm = rng.permutation(len(self.data))
            self.data = [self.data[i] for i in perm]
        else:
            if num_frames > len(self.labeled_data):
                raise ArithmeticError(
                    "Labeled data size is %d, while sampling size is %d."
                    % (len(self.labeled_data), num_frames)
                )
            idx = rng.choice(len(self.labeled_data), size=num_frames, replace=False)
            self.data = [self.labeled_data[i] for i in idx]

    def resample_unlabeled_data(self) -> None:
        self.data = [self.unlabeled_data[g] for g in self.unlabeled_data]

    # -- misc ----------------------------------------------------------------

    def get_al_dict_for_coreset(self) -> Dict[int, np.ndarray]:
        """Labeled poses as [K, 3] features for coreset init
        (reference: dataset/dataset.py:47-51)."""
        return {
            idx: np.asarray(self.labeled_data[idx]["3d_keypoints"])[:, :3]
            for idx in range(len(self.labeled_data))
        }

    def __len__(self) -> int:
        return len(self.data)
