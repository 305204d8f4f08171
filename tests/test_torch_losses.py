"""The port's training losses and batch finishing against the JAX
package's, on the same inputs (the port's layout [N, K, h, w], JAX's
[N, h, w, K]):

  * ``heatmap_mse_loss`` with a per-(sample, joint) mask and the real
    sample count in the denominator, and without either: rtol 1e-5 (one
    float32 sum over a few thousand terms, in another order: 2.3e-6 seen);
  * ``integral_regression_loss`` with and without joint masks, with joints
    whose GT Gaussian leaves the crop (peak below 0.1, dropped): rtol 1e-5
    (softmax moments and the target's linear expectation, summed in another
    order);
  * ``data/pipeline.py::device_prepare``: the GT heatmaps with a sigma per
    frame, atol 1e-6, and the normalized images, atol 1e-5 (float32
    division and subtraction in the same order); DATA.NUM_AUG > 0 raises,
    naming ROADMAP A7b, in the pipeline and in the engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.data.pipeline import device_prepare as jax_device_prepare
from multi_view_active_learning_tpu.ops import heatmap as jax_heatmap
from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data.pipeline import device_prepare
from multi_view_active_learning_tpu_torch.engine import check_ported
from multi_view_active_learning_tpu_torch.ops import heatmap

N, K, H, W = 6, 5, 16, 12


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0.0, 0.3, size=(N, K, H, W)).astype(np.float32)
    # GT Gaussians; the last joints of some samples sit outside the crop.
    kp = rng.uniform(1.0, [W - 1.0, H - 1.0], size=(N, K, 2)).astype(np.float32)
    kp[::2, -1] = [-20.0, 40.0]
    target = heatmap.render_gaussian_heatmaps(torch.from_numpy(kp), H, W, 1.5).numpy()
    valid = rng.random((N, K)) > 0.25
    return pred, target, valid


def _nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


@pytest.mark.parametrize("masked", [True, False])
def test_heatmap_mse_loss_matches_jax(masked):
    pred, target, valid = _inputs(0)
    if masked:
        got = heatmap.heatmap_mse_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                       torch.from_numpy(valid)[:, :, None, None],
                                       num_samples=torch.tensor(4.0))
        ref = jax_heatmap.heatmap_mse_loss(_nhwc(pred), _nhwc(target),
                                           jnp.asarray(valid)[:, None, None, :], num_samples=4.0)
    else:
        got = heatmap.heatmap_mse_loss(torch.from_numpy(pred), torch.from_numpy(target))
        ref = jax_heatmap.heatmap_mse_loss(_nhwc(pred), _nhwc(target))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("beta", [10.0, 1.0])
def test_integral_regression_loss_matches_jax(masked, beta):
    pred, target, valid = _inputs(1)
    mask = torch.from_numpy(valid) if masked else None
    got = heatmap.integral_regression_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                           mask, beta=beta)
    ref = jax_heatmap.integral_regression_loss(_nhwc(pred), _nhwc(target),
                                               jnp.asarray(valid) if masked else None, beta=beta)
    assert float(ref) > 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_device_prepare_matches_jax():
    rng = np.random.default_rng(2)
    B, V, K_, IMG, stride = 2, 3, 4, 32, 4
    images = rng.integers(0, 256, size=(B, V, IMG, IMG, 3)).astype(np.uint8)
    kp = rng.uniform(0, IMG, size=(B, V, K_, 2)).astype(np.float32)
    sigma = np.array([2.0, 3.5], np.float32)
    got_img, got_heat = device_prepare(torch.from_numpy(images), torch.from_numpy(kp),
                                       torch.from_numpy(sigma), stride=stride, train=True)
    ref_img, ref_heat = jax_device_prepare(jnp.asarray(images), jnp.asarray(kp),
                                           jnp.asarray(sigma), None, stride=stride, train=True)
    assert got_heat.shape == (B, V, K_, IMG // stride, IMG // stride)
    np.testing.assert_allclose(got_heat.numpy(), np.moveaxis(np.asarray(ref_heat), -1, 2),
                               atol=1e-6)
    assert got_img.dtype == torch.float32
    np.testing.assert_allclose(got_img.numpy(), np.asarray(ref_img), atol=1e-5)


def test_num_aug_raises():
    images = torch.zeros((1, 1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="A7b"):
        device_prepare(images, torch.zeros((1, 1, 2, 2)), torch.ones(1), train=True, num_aug=2)
    # Eval batches never augment.
    device_prepare(images, torch.zeros((1, 1, 2, 2)), torch.ones(1), train=False, num_aug=2)
    cfg = get_default_configs()
    cfg.DATA.NUM_AUG = 2
    with pytest.raises(NotImplementedError, match="A7b"):
        check_ported(cfg)
