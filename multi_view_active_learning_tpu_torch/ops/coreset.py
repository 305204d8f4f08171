"""k-center-greedy coreset selection on the device.

Semantics of the JAX package's ops/coreset.py (reference:
utils/coreset.py:13-95): labeled points can never win the argmax; a
selected point's distance drops to 0 so it is not re-selected; ties go to
the first index.

The initial min-distance-to-labeled sweep is K2
(``kernels/pairwise.py``): the CUDA kernel on a CUDA tensor, its plain
chunked version (``_min_dist_to_centers``) on a CPU tensor.  The greedy
steps are a plain loop of argmax + one distance update, as the JAX
package's ``fori_loop`` runs them outside Pallas.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import pairwise

_min_dist_to_centers = pairwise.min_distance_to_centers_plain


def k_center_greedy(
    features: torch.Tensor, labeled_mask: torch.Tensor, n_select: int
) -> torch.Tensor:
    """Greedy k-center selection.

    features: [n, d] float32; labeled_mask: [n] bool (initial centers).
    Returns [n_select] int64 indices into `features`, all from the unlabeled
    part, in selection order.
    """
    min_dist = pairwise.min_distance_to_centers(features, labeled_mask)
    # Labeled points are hard-excluded from the argmax: the expanded
    # ||x||^2 + ||c||^2 - 2 x.c form can leave them a tiny positive distance
    # to themselves (cancellation), which would otherwise beat exhausted
    # unlabeled points sitting at exactly 0.
    excluded = torch.full_like(min_dist, -1.0)
    selected = torch.empty((n_select,), dtype=torch.int64, device=features.device)
    for i in range(n_select):
        ind = torch.argmax(torch.where(labeled_mask, excluded, min_dist))
        d = torch.sqrt(
            torch.clamp(torch.sum(torch.square(features - features[ind]), dim=-1), min=0.0)
        )
        min_dist = torch.minimum(min_dist, d)
        selected[i] = ind
    return selected


def center_poses(poses: np.ndarray, root_index: int) -> np.ndarray:
    """Root-center and flatten 3D poses into coreset features.

    poses: [n, K, 3] -> [n, 3K], in the reference's (3, K) flattening order
    (utils/coreset.py:35-47) so distances match.
    """
    arr = np.transpose(np.asarray(poses, dtype=np.float32), (0, 2, 1))  # [n, 3, K]
    arr = arr - arr[:, :, root_index : root_index + 1]
    return arr.reshape(arr.shape[0], -1)


class CoreSet:
    """Reference-compatible wrapper (utils/coreset.py:13-95).

    sal_dict: {guid: pose [K, 3]-like} for the unlabeled pool;
    al_dict: {key: pose} for the already-labeled set.

    ``features`` replaces the pose feature space with an explicit
    [len(sal_dict) + len(al_dict), C] matrix, rows in sal-then-al order: the
    AL.CORESET_FEATURES=EMBEDDING path (pooled trunk embeddings from
    ``Engine.score_step`` / ``embed_step``), ranked by K2 at d = C.  A tensor
    of features keeps its device unless ``device`` is given.
    """

    def __init__(self, sal_dict, al_dict, joint_root_index: int,
                 device: Optional[Union[str, torch.device]] = None, features=None):
        self.sal_keys: List = list(sal_dict.keys())
        self.n_sal = len(sal_dict)
        self.n_obs = len(sal_dict) + len(al_dict)
        if features is not None:
            if device is None and torch.is_tensor(features):
                device = features.device
            self.device = resolve_device(device)
            self.features = torch.as_tensor(features, dtype=torch.float32, device=self.device)
            if self.features.dim() != 2 or self.features.shape[0] != self.n_obs:
                raise ValueError("features %s do not have one row for each of the %d pool "
                                 "entries" % (tuple(self.features.shape), self.n_obs))
            return
        self.device = resolve_device(device)
        sal = [np.asarray(v) for v in sal_dict.values()]
        al = [np.asarray(v) for v in al_dict.values()]
        # The reference stores poses as [K, rows>=3] lists; keep [K, 3].
        all_poses = np.stack([p[:, :3] for p in sal + al])
        self.features = center_poses(all_poses, joint_root_index)

    def select_batch(self, n: int) -> List:
        labeled = torch.zeros((self.n_obs,), dtype=torch.bool, device=self.device)
        labeled[self.n_sal:] = True
        feats = torch.as_tensor(self.features, device=self.device)
        idx = k_center_greedy(feats, labeled, int(n)).cpu().numpy()
        if not (idx < self.n_sal).all():
            raise RuntimeError("greedy selected a labeled point")
        return [self.sal_keys[i] for i in idx]
