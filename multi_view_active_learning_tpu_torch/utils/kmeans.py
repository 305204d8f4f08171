"""Minimal KMeans: k-means++ seeding on the host, Lloyd's algorithm in torch.

The port's counterpart of the JAX package's utils/kmeans.py, which
replaces the reference's sklearn.cluster.KMeans for the SAL pose clusters
(reference: strategy.py:38-52, 973-991).  The seeding is the same numpy
code, so the initial centers are identical for a seed; the Lloyd
iterations and ``predict`` run on the given device (the card unless the
caller asks for the CPU), with the same ||x||^2 + ||c||^2 - 2 x.c distances.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device


def _pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[n, d] x [k, d] -> squared distances [n, k]."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    cc = torch.sum(c * c, dim=-1)
    return torch.clamp(xx + cc[None, :] - 2.0 * x @ c.T, min=0.0)


def kmeans_pp_seeds(xs: np.ndarray, n_clusters: int, random_state: int) -> np.ndarray:
    """k-means++ seeding with a running min-distance vector; falls back to a
    uniform pick where the D^2 distribution has no mass (duplicate poses, or
    fewer distinct poses than clusters), as sklearn does."""
    rng = np.random.default_rng(random_state)
    centers = [xs[rng.integers(len(xs))]]
    d2 = ((xs - centers[0]) ** 2).sum(-1)
    for _ in range(1, n_clusters):
        total = float(d2.sum())
        if not np.isfinite(total) or total <= 1e-12:
            idx = int(rng.integers(len(xs)))
        else:
            idx = int(rng.choice(len(xs), p=d2 / total))
        centers.append(xs[idx])
        d2 = np.minimum(d2, ((xs - xs[idx]) ** 2).sum(-1))
    return np.stack(centers)


class KMeans:
    """fit / predict shaped like sklearn's (the part the SAL loop uses)."""

    def __init__(self, n_clusters: int, random_state: int = 0, n_iters: int = 50,
                 device: Optional[Union[str, torch.device]] = None):
        self.n_clusters = n_clusters
        self.random_state = int(random_state) & 0x7FFFFFFF
        self.n_iters = n_iters
        self.device = resolve_device(device)
        self.cluster_centers_: Optional[torch.Tensor] = None

    def fit(self, features) -> "KMeans":
        xs = np.asarray(features, dtype=np.float32)
        x = torch.as_tensor(xs, device=self.device)
        centers = torch.as_tensor(kmeans_pp_seeds(xs, self.n_clusters, self.random_state),
                                  device=self.device)
        for _ in range(self.n_iters):
            assign = torch.argmin(_pairwise_sq(x, centers), dim=-1)
            onehot = torch.nn.functional.one_hot(assign, self.n_clusters).to(x.dtype)  # [n, k]
            counts = torch.sum(onehot, dim=0)
            new_centers = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
            # Empty clusters keep their center.
            centers = torch.where((counts == 0)[:, None], centers, new_centers)
        self.cluster_centers_ = centers
        return self

    def predict(self, features) -> np.ndarray:
        x = torch.as_tensor(np.asarray(features, dtype=np.float32), device=self.device)
        if x.dim() == 1:
            x = x[None]
        return torch.argmin(_pairwise_sq(x, self.cluster_centers_), dim=-1).cpu().numpy()
