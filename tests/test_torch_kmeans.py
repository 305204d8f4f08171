"""The port's KMeans (utils/kmeans.py: numpy k-means++ seeding, torch Lloyd
iterations and predict) against the JAX package's, on the same points and
seed: the seeds are identical, the fitted centers agree to 1e-5 (float32
sums in another order) and predict gives the same clusters, on separated
blobs and on degenerate pools."""

import numpy as np
import pytest

from multi_view_active_learning_tpu.utils import kmeans as jax_kmeans
from multi_view_active_learning_tpu_torch.utils import kmeans

CENTER_ATOL = 1e-5


def _blobs(seed, k=4, per=50, d=6, spread=20.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=spread, size=(k, d))
    return np.concatenate([c + rng.normal(size=(per, d)) for c in centers]).astype(np.float32)


POOLS = {
    "blobs": (_blobs(0), 4, 1307),
    "blobs_pose_width": (_blobs(3, k=10, per=12, d=57), 10, 20),
    "identical": (np.ones((6, 5), np.float32), 4, 0),
    "two_points": (np.concatenate([np.zeros((3, 5)), np.ones((3, 5))]).astype(np.float32), 4, 0),
}


def _jax_fit(monkeypatch, pts, k, seed):
    """The JAX KMeans fitted, with the seeds it handed to Lloyd."""
    seen = {}
    fit = jax_kmeans._fit

    def spy(x, init, k, n_iters):
        seen["init"] = np.asarray(init)
        return fit(x, init, k, n_iters)

    monkeypatch.setattr(jax_kmeans, "_fit", spy)
    return jax_kmeans.KMeans(k, random_state=seed).fit(pts), seen["init"]


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_kmeans_matches_jax(monkeypatch, pool):
    pts, k, seed = POOLS[pool]
    ref, ref_seeds = _jax_fit(monkeypatch, pts, k, seed)
    np.testing.assert_array_equal(kmeans.kmeans_pp_seeds(pts, k, seed), ref_seeds)
    got = kmeans.KMeans(k, random_state=seed, device="cpu").fit(pts)
    np.testing.assert_allclose(got.cluster_centers_.numpy(), np.asarray(ref.cluster_centers_),
                               rtol=0, atol=CENTER_ATOL)
    np.testing.assert_array_equal(got.predict(pts), ref.predict(pts))
    np.testing.assert_array_equal(got.predict(pts[0]), ref.predict(pts[0]))


def test_kmeans_recovers_blobs():
    pts = _blobs(1)
    pred = kmeans.KMeans(4, random_state=7, device="cpu").fit(pts).predict(pts)
    assert all(len(set(pred[b * 50:(b + 1) * 50].tolist())) == 1 for b in range(4))
    assert len(set(pred.tolist())) == 4


def test_kmeans_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans.KMeans(4)
