"""Geometry and RANSAC-DLT triangulation: the port against the JAX package
and against the reference goldens (tests/fixtures/parity_goldens.npz).

The port takes heatmaps [B, V, K, h, w]; the JAX package [B, V, h, w, K].

Tolerances against JAX on camera-ring rigs: hard decodes and inlier counts
exact; soft decodes rtol=1e-4, atol=1e-3 (K1's softmax moments);
3D points atol=0.05 and the metric rtol=1e-4, atol=1e-3 on a ~30-unit scene
(the same float32 algorithm with sums in another order; for eigh, two
LAPACK eigensolvers on the normal equations, whose conditioning is squared).
Direct optimization (``_huber_refine``, 32 Levenberg-Marquardt steps) is held
to the same bounds: the port's closed-form Jacobian and JAX's ``jacfwd``
round differently, and the accepted steps reach the same optimum.  The
bbox decode: hard decodes exact, soft rtol=1e-4, atol=1e-3.  Against the goldens, the bounds
of tests/test_parity_goldens.py: decodes bit-exact, inlier counts equal,
svd atol=0.05, power atol=1.0, metric within 0.15, XE rtol=1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_ring_cameras, synthetic_multiview_problem
from multi_view_active_learning_tpu.ops import geometry as jax_geometry
from multi_view_active_learning_tpu.ops import heatmap as jax_heatmap
from multi_view_active_learning_tpu.ops import triangulate as jax_tri
from multi_view_active_learning_tpu_torch.ops import geometry, heatmap, triangulate

GOLD = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "parity_goldens.npz"))


def _np(x):
    return np.asarray(x)


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    proj = make_ring_cameras(5)
    pts = rng.normal(scale=30.0, size=(5, 7, 3)).astype(np.float32)
    kp2d = rng.uniform(0, 256, size=(5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        geometry.project_points(torch.from_numpy(proj), torch.from_numpy(pts)).numpy(),
        _np(jax_geometry.project_points(jnp.asarray(proj), jnp.asarray(pts))),
        rtol=1e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        geometry.reprojection_error(
            torch.from_numpy(pts[0]), torch.from_numpy(kp2d), torch.from_numpy(proj)
        ).numpy(),
        _np(jax_geometry.reprojection_error(
            jnp.asarray(pts[0]), jnp.asarray(kp2d), jnp.asarray(proj))),
        rtol=1e-5, atol=1e-4,
    )
    homo = np.array([[1.0, 2.0, 0.0], [3.0, 4.0, 2.0]], np.float32)  # z == 0 guard
    np.testing.assert_array_equal(
        geometry.homogeneous_to_euclidean(torch.from_numpy(homo)).numpy(),
        _np(jax_geometry.homogeneous_to_euclidean(jnp.asarray(homo))),
    )
    np.testing.assert_array_equal(
        geometry.Camera(np.eye(3), [1, 2, 3], np.eye(3)).projection,
        jax_geometry.Camera(np.eye(3), [1, 2, 3], np.eye(3)).projection,
    )


@pytest.mark.parametrize("num_views,n_iters,seed", [
    (31, 64, 1307), (8, -1, 0), (6, 64, 5), (12, 20, 2**31 - 2),
])
def test_all_view_pairs_match_jax(num_views, n_iters, seed):
    np.testing.assert_array_equal(
        triangulate.all_view_pairs(num_views, n_iters, seed),
        jax_tri.all_view_pairs(num_views, n_iters, seed),
    )


def test_null_vector_solvers_match_jax():
    A = np.random.default_rng(1).normal(size=(6, 8, 4)).astype(np.float32)
    for method in ("power", "eigh", "svd"):
        got = triangulate._null_vector(torch.from_numpy(A), method).numpy()
        ref = _np(jax_tri._null_vector(jnp.asarray(A), method))
        got = got * np.sign(got[..., :1] * ref[..., :1])  # sign is free
        np.testing.assert_allclose(got, ref, atol=1e-4)
    M = np.random.default_rng(2).normal(size=(3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        triangulate._adjugate4(torch.from_numpy(M)).numpy(),
        _np(jax_tri._adjugate4(jnp.asarray(M))), rtol=1e-5, atol=1e-5,
    )


def _rig_problem(seed=0, batch=2, views=6, joints=5):
    """Gaussian heatmaps around projected points on a ring rig, with one
    corrupted view per joint so RANSAC has outliers to reject."""
    _, proj, _, grid = synthetic_multiview_problem(
        batch=batch, num_views=views, num_joints=joints, seed=seed
    )
    rng = np.random.default_rng(seed + 100)
    grid = grid.astype(np.float64)
    grid[:, 1, :, :] = rng.uniform(4, 60, size=(batch, joints, 2))  # view 1 is wrong
    yy, xx = np.mgrid[0:64, 0:64]
    d2 = (xx - grid[..., 0, None, None]) ** 2 + (yy - grid[..., 1, None, None]) ** 2
    hm = np.exp(-d2 / (2 * 1.5 ** 2)) + rng.normal(scale=0.02, size=d2.shape)
    hm = hm.astype(np.float32)  # [B, V, K, h, w]
    valid = np.ones((batch, joints), bool)
    valid[1, 3] = False
    return hm, np.ascontiguousarray(proj), valid


CONFIGS = {
    "power": dict(method="power"),
    "eigh": dict(method="eigh"),
    "svd": dict(method="svd"),
    "power-soft": dict(method="power", use_soft_argmax=True),
    "svd-soft": dict(method="svd", use_soft_argmax=True),
    "power-confidence": dict(method="power", confidence_weighted=True),
    "power-xe": dict(method="power", use_reprojection_xe=True, sigma=1.0),
    "power-direct": dict(method="power", direct_optimization=True),
    "svd-direct": dict(method="svd", direct_optimization=True),
    "power-soft-direct": dict(method="power", use_soft_argmax=True, direct_optimization=True),
    "power-confidence-direct": dict(method="power", confidence_weighted=True,
                                    direct_optimization=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_triangulate_frames_matches_jax(name):
    kw = CONFIGS[name]
    hm, proj, valid = _rig_problem()
    pairs = jax_tri.all_view_pairs(6)
    ref = jax_tri.triangulate_frames(
        jnp.asarray(np.moveaxis(hm, 2, -1)), jnp.asarray(proj), jnp.asarray(valid),
        jnp.asarray(pairs), stride=4, **kw,
    )
    got = triangulate.triangulate_frames(
        torch.from_numpy(hm), torch.from_numpy(proj), torch.from_numpy(valid),
        torch.from_numpy(pairs), stride=4, **kw,
    )
    if kw.get("use_soft_argmax"):
        np.testing.assert_allclose(got["keypoints_2d"].numpy(), _np(ref["keypoints_2d"]),
                                   rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got["keypoints_2d"].numpy(), _np(ref["keypoints_2d"]))
    np.testing.assert_array_equal(got["inlier_count"].numpy(), _np(ref["inlier_count"]))
    np.testing.assert_array_equal(got["per_joint_inliers"].numpy(),
                                  _np(ref["per_joint_inliers"]))
    np.testing.assert_allclose(got["keypoints_3d"].numpy(), _np(ref["keypoints_3d"]), atol=5e-2)
    np.testing.assert_allclose(got["metric"].numpy(), _np(ref["metric"]), rtol=1e-4, atol=1e-3)
    if not kw.get("use_soft_argmax"):
        # The corrupted view is rejected for every valid joint.  (The
        # soft-argmax of a whole [0, 1] map leans to its center, the
        # reference's quirk, and pulls every view within the threshold.)
        assert (got["per_joint_inliers"].numpy()[valid] == 5).all()


def test_direct_optimization_moves_the_refit():
    """The refine runs: the refit point moves, and its reprojection error
    over the inliers does not grow."""
    hm, proj, valid = _rig_problem(seed=3)
    args = (torch.from_numpy(hm), torch.from_numpy(proj), torch.from_numpy(valid),
            torch.from_numpy(jax_tri.all_view_pairs(6)))
    plain = triangulate.triangulate_frames(*args, stride=4, use_soft_argmax=True)
    refined = triangulate.triangulate_frames(*args, stride=4, use_soft_argmax=True,
                                             direct_optimization=True)
    assert not torch.equal(plain["keypoints_3d"][valid], refined["keypoints_3d"][valid])
    assert (refined["metric"] <= plain["metric"] + 1e-4).all()


def _refine_problem(seed):
    rng = np.random.default_rng(seed)
    B, K, V = 2, 3, 6
    proj = np.broadcast_to(make_ring_cameras(V), (B, V, 3, 4)).astype(np.float32)
    pts = rng.normal(scale=30.0, size=(B, K, 3))
    obs = np.stack([[jax_geometry.project_points_np(proj[b, v].astype(np.float64), pts[b])
                     for v in range(V)] for b in range(B)])  # [B, V, K, 2]
    obs = np.swapaxes(obs, 1, 2) + rng.normal(scale=1.5, size=(B, K, V, 2))
    obs[:, :, 2] += 40.0  # an outlier view, down-weighted by the Huber loss
    x0 = pts + rng.normal(scale=2.0, size=pts.shape)
    mask = np.ones((B, K, V), np.float32)
    mask[0, 1, 4] = 0.0
    return [a.astype(np.float32) for a in (x0, proj, obs, mask)]


def test_huber_refine_matches_jax():
    """atol 1e-2 world units: both packages land within 5e-3 of the float64
    optimum (measured: port 4.6e-3, JAX 1.8e-3; converged by step 16), the
    float32 floor of a flat Huber minimum with 1.5-pixel noise."""
    x0, proj, obs, mask = _refine_problem(6)
    args = [torch.from_numpy(a) for a in (x0, proj, obs, mask)]
    args[1] = args[1][:, None]
    got = triangulate._huber_refine(*args, 32).numpy()
    exact = triangulate._huber_refine(*(a.double() for a in args), 32).numpy()
    refine = jax.vmap(jax.vmap(lambda x, pr, pt, m: jax_tri._huber_refine(x, pr, pt, m, 32),
                               in_axes=(0, None, 0, 0)))
    ref = np.asarray(refine(*(jnp.asarray(a) for a in (x0, proj, obs, mask))))
    np.testing.assert_allclose(got, ref, atol=1e-2)
    np.testing.assert_allclose(got, exact, atol=1e-2)
    assert np.abs(got - x0).max() > 0.1  # it moved from the start


def test_solve3_matches_jax_and_guards_singular():
    rng = np.random.default_rng(8)
    H = rng.normal(size=(4, 3, 3)).astype(np.float32)
    H[3] = 0.0  # singular: |det| < 1e-30 is taken as 1e-30
    b = rng.normal(size=(4, 3)).astype(np.float32)
    got = triangulate._solve3(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_tri._solve3(jnp.asarray(H), jnp.asarray(b)))
    np.testing.assert_allclose(got[:3], ref[:3], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[:3], np.linalg.solve(H[:3], b[:3, :, None])[..., 0], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_decode_keypoints_bbox_matches_jax(soft):
    rng = np.random.default_rng(9)
    hm = (rng.normal(size=(2, 3, 4, 16, 24)) * 3).astype(np.float32)  # [B, V, K, h, w]
    bbox = np.stack([rng.uniform(0, 50, size=(2, 3)), rng.uniform(0, 50, size=(2, 3)),
                     rng.uniform(60, 200, size=(2, 3)), rng.uniform(60, 120, size=(2, 3))],
                    axis=-1).astype(np.float32)  # non-square boxes
    got = heatmap.decode_keypoints_bbox(torch.from_numpy(hm), torch.from_numpy(bbox), soft).numpy()
    ref = np.asarray(jax_heatmap.decode_keypoints_bbox(jnp.asarray(hm), jnp.asarray(bbox), soft))
    assert got.shape == (2, 3, 4, 2)
    if soft:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, ref)


def _golden(case, **kw):
    heat = GOLD["%s_heatmaps" % case][None]  # [1, V, K, h, w]: the port's layout
    return triangulate.triangulate_frames(
        torch.from_numpy(heat),
        torch.from_numpy(GOLD["fixture_proj"][None]),
        torch.ones((1, 19), dtype=torch.bool),
        torch.from_numpy(triangulate.all_view_pairs(8)),
        stride=int(GOLD["fixture_stride"]),
        **kw,
    )


@pytest.mark.parametrize("case", ["fixture", "ransac"])
def test_golden_decode_is_bit_exact(case):
    out = _golden(case)
    np.testing.assert_array_equal(
        out["keypoints_2d"][0].numpy().astype(np.float64), GOLD["%s_keypoints_2d" % case]
    )


@pytest.mark.parametrize("case", ["fixture", "ransac"])
def test_golden_inlier_selection_matches(case):
    assert float(_golden(case)["inlier_count"][0]) == float(GOLD["%s_inlier_count" % case])


@pytest.mark.parametrize("case", ["fixture", "ransac"])
def test_golden_3d_parity_svd(case):
    out = _golden(case, method="svd")
    np.testing.assert_allclose(
        out["keypoints_3d"][0].numpy().astype(np.float64), GOLD["%s_keypoints_3d" % case],
        atol=0.05,
    )
    assert abs(float(out["metric"][0]) - float(GOLD["%s_metric" % case])) < 0.15


@pytest.mark.parametrize("case", ["fixture", "ransac"])
def test_golden_3d_parity_power(case):
    out = _golden(case)
    np.testing.assert_allclose(
        out["keypoints_3d"][0].numpy().astype(np.float64), GOLD["%s_keypoints_3d" % case],
        atol=1.0,
    )


def test_golden_ransac_rejects_corrupted_views():
    out = _golden("ransac")
    assert float(out["inlier_count"][0]) == 8 - len(GOLD["ransac_corrupted_views"])


def test_golden_reprojection_xe():
    out = _golden("fixture", use_reprojection_xe=True, sigma=1.0)
    np.testing.assert_allclose(float(out["metric"][0]), float(GOLD["fixture_xe_metric"]),
                               rtol=1e-5)
