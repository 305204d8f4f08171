"""The port's uncertainty metrics (ops/uncertainty.py) against the JAX
package's and the skimage 0.19.3 oracle (tests/oracle_ports.py).

The port takes heatmaps [B, V, K, h, w]; the JAX package [B, V, h, w, K].

Tolerances:
  * ``local_peak_mask``: equal to JAX's and to the oracle's peak set, on
    random maps, few-level plateaus, quantized blobs, chains of equal
    neighbours (a 32-long ridge, a staircase, a checkerboard of ties), flat
    maps, single peaks and peaks on the border.
  * MPE / HP / BSB against the ``unc_*`` goldens of parity_goldens.npz: the
    JAX test's bounds (tests/test_parity_goldens.py:106-113), rtol 1e-5 for
    AVG, rtol 2e-4 and atol 2e-5 for STD.
  * The same metrics against the JAX functions on random heatmaps with
    invalid joints: the same bounds (float32, sums in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle_ports import peak_local_max
from multi_view_active_learning_tpu.ops import uncertainty as jax_unc
from multi_view_active_learning_tpu_torch.ops import uncertainty

GOLD = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "parity_goldens.npz"))
H, W = 24, 32
TOL = {"AVG": dict(rtol=1e-5), "STD": dict(rtol=2e-4, atol=2e-5)}
METRICS = {
    "mpe": (uncertainty.multi_peak_entropy, jax_unc.multi_peak_entropy),
    "hp": (uncertainty.highest_probability, jax_unc.highest_probability),
    "bsb": (uncertainty.best_vs_second_best, jax_unc.best_vs_second_best),
}


def _suite(rng):
    """Maps where peak finding is easy to get wrong."""
    imgs = [rng.random((H, W), dtype=np.float32) for _ in range(4)]
    imgs += [rng.integers(0, 4, (H, W)).astype(np.float32) for _ in range(4)]  # plateaus
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(4):  # quantized blobs: int8-style ties
        img = np.zeros((H, W), np.float32)
        for _ in range(int(rng.integers(1, 5))):
            cy, cx = rng.integers(0, H), rng.integers(0, W)
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
        imgs.append(np.round(img * 8) / 8)
    ridge = np.zeros((H, W), np.float32)
    ridge[11, :] = 2.0  # a chain of 32 equal neighbours, border to border
    ridge[3:21, 7] = 2.0
    stair = np.zeros((H, W), np.float32)
    for i in range(H):
        stair[i, min(i + 4, W - 1)] = 1.0  # a diagonal chain of ties
    checker = ((yy + xx) % 2).astype(np.float32)  # ties everywhere
    flat = np.full((H, W), 3.25, np.float32)
    single = np.zeros((H, W), np.float32)
    single[9, 17] = 1.0
    border = np.zeros((H, W), np.float32)
    border[0, 5] = border[H - 1, 3] = border[7, 0] = border[8, W - 2] = 1.0
    border[12, 12] = 0.5
    return np.stack(imgs + [ridge, stair, checker, flat, single, border])


@pytest.mark.parametrize("min_distance", [1, 2, 3])
def test_local_peak_mask_equals_jax_and_oracle(min_distance):
    imgs = _suite(np.random.default_rng(min_distance))
    got = uncertainty.local_peak_mask(torch.from_numpy(imgs), min_distance).numpy()
    ref = np.asarray(jax_unc.local_peak_mask(jnp.asarray(imgs), min_distance))
    np.testing.assert_array_equal(got, ref)
    for i, img in enumerate(imgs):
        want = np.zeros((H, W), bool)
        for r, c in peak_local_max(img, min_distance=min_distance, indices=True):
            want[r, c] = True
        np.testing.assert_array_equal(got[i], want, err_msg="map %d" % i)
    assert not got[-3].any()  # the flat map has no peak
    assert got[-2].sum() == 1 and got[-2][9, 17]


def test_local_peak_mask_keeps_leading_axes():
    imgs = _suite(np.random.default_rng(7))[:12].reshape(2, 3, 2, H, W)
    got = uncertainty.local_peak_mask(torch.from_numpy(imgs)).numpy()
    ref = uncertainty.local_peak_mask(torch.from_numpy(imgs.reshape(12, H, W))).numpy()
    np.testing.assert_array_equal(got.reshape(12, H, W), ref)


@pytest.mark.parametrize("aggregate", ["AVG", "STD"])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_goldens(name, aggregate):
    heat = torch.from_numpy(GOLD["unc_heatmaps"][None])  # [1, V, K, h, w]: the port's layout
    valid = torch.from_numpy(GOLD["unc_joint_valid"][None])
    got = float(METRICS[name][0](heat, valid, aggregate)[0])
    np.testing.assert_allclose(got, float(GOLD["unc_%s_%s" % (name, aggregate.lower())]),
                               **TOL[aggregate])


def _random_heatmaps(seed, B=2, V=3, K=4, h=16, w=20):
    """Blobs plus noise, a few quantized to plateaus; joint (1, 2) invalid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    hm = rng.normal(scale=0.05, size=(B, V, K, h, w))
    for idx in np.ndindex(B, V, K):
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            hm[idx] += rng.uniform(0.3, 1.0) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0)
    hm[0, 1] = np.round(hm[0, 1] * 4) / 4
    valid = np.ones((B, K), bool)
    valid[1, 2] = False
    return hm.astype(np.float32), valid


@pytest.mark.parametrize("aggregate", ["AVG", "STD"])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_jax_on_random_heatmaps(name, aggregate):
    hm, valid = _random_heatmaps(3)
    port_fn, jax_fn = METRICS[name]
    got = port_fn(torch.from_numpy(hm), torch.from_numpy(valid), aggregate).numpy()
    ref = np.asarray(jax_fn(jnp.asarray(np.moveaxis(hm, 2, -1)), jnp.asarray(valid), aggregate))
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL[aggregate])
    # An invalid joint does not enter: changing its maps changes nothing.
    hm2 = hm.copy()
    hm2[1, :, 2] = np.random.default_rng(4).random(hm2[1, :, 2].shape)
    np.testing.assert_array_equal(
        port_fn(torch.from_numpy(hm2), torch.from_numpy(valid), aggregate).numpy(), got)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_unknown_aggregate_raises(name):
    hm, valid = _random_heatmaps(5)
    with pytest.raises(ValueError, match="AVG or STD"):
        METRICS[name][0](torch.from_numpy(hm), torch.from_numpy(valid), "MEDIAN")


def test_bsb_without_a_second_peak_reads_zero():
    """A map whose row-softmax has one local peak: the missing second peak
    reads as probability 0, in both packages."""
    hm = np.tile(np.arange(16, dtype=np.float32), (16, 1))[None, None, None] * -1.0
    hm[0, 0, 0, 8, 8] = 6.0
    probs = torch.softmax(torch.from_numpy(hm), dim=-1)
    assert int(uncertainty.local_peak_mask(probs).sum()) == 1
    got = float(uncertainty.best_vs_second_best(torch.from_numpy(hm), np.ones((1, 1), bool))[0])
    ref = float(jax_unc.best_vs_second_best(jnp.asarray(np.moveaxis(hm, 2, -1)),
                                            jnp.ones((1, 1), bool))[0])
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, float(probs[0, 0, 0, 8, 8]), rtol=1e-6)
