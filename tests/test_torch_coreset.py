"""K2 and k-center-greedy: the port against the JAX package.

Tolerance of the min-distance sweep: rtol=1e-3, atol=5e-3, as
tests/test_pallas_kernels.py holds the Pallas kernel -- a labeled point's
zero distance to itself sits on the float32 cancellation floor of the
expanded ||x||^2 + ||c||^2 - 2 x.c form (sqrt(eps) ~ 4e-3).

The CUDA kernel cannot run here, so its launch plan is tested directly and
a Python model of its work split (clusters of rows, mask chunks compacted
in order, each rank's slice in tiles of warp groups, each tile walked over
the feature axis in pieces, the cluster min) is held to the plain version."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.ops import coreset as jax_coreset
from multi_view_active_learning_tpu.ops.pallas import pairwise as jax_pairwise
from multi_view_active_learning_tpu_torch import kernels
from multi_view_active_learning_tpu_torch.kernels import _build, pairwise
from multi_view_active_learning_tpu_torch.ops import coreset

TOL = dict(rtol=1e-3, atol=5e-3)


def _pool(seed, n, d, mask_fn):
    feats = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask_fn(mask)
    return feats, mask


CASES = {
    "tail": (3, 300, 57, lambda m: m.__setitem__(slice(250, None), True)),
    "strided": (4, 600, 16, lambda m: m.__setitem__(slice(None, None, 7), True)),
    "chunks": (5, 2100, 9, lambda m: m.__setitem__(slice(1500, 1700), True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_min_distance_plain_matches_jax(case):
    feats, mask = _pool(*CASES[case])
    got = pairwise.min_distance_to_centers(torch.from_numpy(feats), torch.from_numpy(mask)).numpy()
    oracle = np.asarray(jax_coreset._min_dist_to_centers(jnp.asarray(feats), jnp.asarray(mask)))
    np.testing.assert_allclose(got, oracle, **TOL)
    if case != "chunks":  # the interpreted Pallas kernel is slow at 2100 rows
        pallas = np.asarray(jax_pairwise.min_distance_to_centers(
            jnp.asarray(feats), jnp.asarray(mask), interpret=True))
        np.testing.assert_allclose(got, pallas, **TOL)
    assert coreset._min_dist_to_centers is pairwise.min_distance_to_centers_plain


def test_no_centers_gives_inf_like_the_oracle():
    feats, mask = _pool(6, 50, 8, lambda m: None)
    got = pairwise.min_distance_to_centers(torch.from_numpy(feats), torch.from_numpy(mask))
    assert torch.isinf(got).all()
    assert np.isinf(np.asarray(jax_coreset._min_dist_to_centers(
        jnp.asarray(feats), jnp.asarray(mask)))).all()


@pytest.mark.parametrize("seed,n,d,n_labeled,n_select", [
    (0, 200, 57, 40, 25), (1, 500, 12, 100, 60), (2, 64, 3, 0, 10),
])
def test_k_center_greedy_matches_jax(seed, n, d, n_labeled, n_select):
    feats = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    labeled = np.arange(n) >= n - n_labeled
    got = coreset.k_center_greedy(torch.from_numpy(feats), torch.from_numpy(labeled), n_select)
    ref = jax_coreset.k_center_greedy(jnp.asarray(feats), jnp.asarray(labeled), n_select)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not labeled[got.numpy()].any()


def test_exhausted_pool_never_picks_labeled_points():
    # Every unlabeled point duplicates a labeled one, so all distances sit
    # on the cancellation floor; labeled points must still never win.
    base = np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32)
    feats = np.concatenate([base] * 5)
    labeled = np.zeros(20, bool)
    labeled[:4] = True
    # Which exhausted point wins depends on rounding noise, so the two
    # packages need not agree on the order; both must skip labeled points.
    got = coreset.k_center_greedy(torch.from_numpy(feats), torch.from_numpy(labeled), 12)
    ref = jax_coreset.k_center_greedy(jnp.asarray(feats), jnp.asarray(labeled), 12)
    assert not labeled[got.numpy()].any() and not labeled[np.asarray(ref)].any()


def test_coreset_class_matches_jax():
    rng = np.random.default_rng(7)
    sal = {"s%03d" % i: rng.normal(size=(19, 4)) for i in range(60)}
    al = {"a%03d" % i: rng.normal(size=(19, 3)) for i in range(15)}
    got = coreset.CoreSet(sal, al, joint_root_index=2, device="cpu").select_batch(10)
    ref = jax_coreset.CoreSet(sal, al, joint_root_index=2).select_batch(10)
    assert got == ref
    np.testing.assert_array_equal(
        coreset.center_poses(np.stack(list(sal.values()))[..., :3], 2),
        jax_coreset.center_poses(np.stack(list(sal.values()))[..., :3], 2),
    )


@pytest.mark.parametrize("d", [32, 200])
def test_coreset_class_with_features_matches_jax(d):
    """AL.CORESET_FEATURES=EMBEDDING: explicit [n_obs, d] features (HRNet-W32's
    32-wide and a wider embedding) pick the same guids as the JAX CoreSet."""
    rng = np.random.default_rng(d)
    sal = {"s%03d" % i: rng.normal(size=(19, 3)) for i in range(80)}
    al = {"a%03d" % i: rng.normal(size=(19, 3)) for i in range(20)}
    feats = rng.normal(size=(100, d)).astype(np.float32)
    got = coreset.CoreSet(sal, al, 2, device="cpu", features=feats).select_batch(12)
    ref = jax_coreset.CoreSet(sal, al, joint_root_index=2, features=feats).select_batch(12)
    assert got == ref and len(set(got)) == 12 and all(g.startswith("s") for g in got)
    # A CPU tensor keeps its device (no card needed); a wrong row count raises.
    assert coreset.CoreSet(sal, al, 2, features=torch.from_numpy(feats)).select_batch(12) == ref
    with pytest.raises(ValueError, match="one row for each"):
        coreset.CoreSet(sal, al, 2, device="cpu", features=feats[:-1])


def test_launch_counter_and_input_checks():
    kernels.reset_launch_counts()
    feats, mask = _pool(8, 40, 6, lambda m: m.__setitem__(slice(0, 5), True))
    coreset.k_center_greedy(torch.from_numpy(feats), torch.from_numpy(mask), 5)
    assert kernels.launch_counts()["min_distance_to_centers"] == 0
    with pytest.raises(TypeError):
        pairwise.min_distance_to_centers(torch.from_numpy(feats).double(), torch.from_numpy(mask))
    with pytest.raises(ValueError):
        pairwise.min_distance_to_centers(torch.from_numpy(feats), torch.from_numpy(mask[:-1]))
    with pytest.raises(RuntimeError):
        pairwise.min_distance_to_centers(
            torch.zeros((4, 3), device="meta"), torch.zeros(4, dtype=torch.bool, device="meta"))


# -- the kernel's launch plan and a model of its work split ------------------

SM = 132  # an H100 SXM


def _fma_chain(a, b):
    """sum_k a[..., k] * b[..., k] accumulated over k ascending, in float64
    (csrc/pairwise.cu's fmaf chains, without their float32 rounding)."""
    acc = np.zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    for k in range(a.shape[-1]):
        acc = acc + a[..., k].astype(np.float64) * b[..., k]
    return acc


def _model_kernel(feats, mask, plan):
    """csrc/pairwise.cu's split of the work: returns the distances and, per
    (row block, rank), the (feature piece, center) pairs that rank reduced,
    in order.  Each chain is summed piece by piece, k ascending."""
    n = feats.shape[0]
    out = np.full(n, np.inf)
    visited = {}
    pieces = pairwise.k_pieces(plan)
    for rb in range(plan.row_blocks):
        rows = feats[rb * pairwise.ROWS:(rb + 1) * pairwise.ROWS]
        xsq = sum(_fma_chain(rows[:, k0:k1], rows[:, k0:k1]) for k0, k1 in pieces)
        cta_min = np.full((plan.cluster, rows.shape[0]), np.inf)
        for rank in range(plan.cluster):
            seen = visited.setdefault((rb, rank), [])
            for c0 in range(0, n, plan.chunk):
                listed = c0 + np.flatnonzero(mask[c0:c0 + plan.chunk])  # in index order
                lo, hi = pairwise.rank_slice(len(listed), plan.cluster, rank)
                for t_lo in range(lo, hi, plan.center_tile):
                    cnt = min(plan.center_tile, hi - t_lo)
                    for warp in range(pairwise.WARPS):
                        g = warp * pairwise.GROUP
                        if g >= cnt:
                            continue
                        group = listed[t_lo + g:t_lo + min(g + pairwise.GROUP, cnt)]
                        c = feats[group]
                        csq = np.zeros(len(group))
                        dot = np.zeros((rows.shape[0], len(group)))
                        for p, (k0, k1) in enumerate(pieces):
                            seen.extend((p, int(j)) for j in group)
                            csq = csq + _fma_chain(c[:, k0:k1], c[:, k0:k1])
                            dot = dot + _fma_chain(rows[:, None, k0:k1], c[None, :, k0:k1])
                        d2 = xsq[:, None] + csq[None, :] - 2.0 * dot
                        cta_min[rank] = np.minimum(cta_min[rank], np.maximum(d2, 0.0).min(axis=1))
        out[rb * pairwise.ROWS:(rb + 1) * pairwise.ROWS] = np.sqrt(cta_min.min(axis=0))
    return out.astype(np.float32), visited


MODEL_CASES = {
    "tail": (2047, 57, 132, lambda m: m.__setitem__(slice(1847, None), True)),  # ragged n
    "scattered": (700, 16, SM, lambda m: m.__setitem__(slice(3, None, 37), True)),
    "single": (300, 9, SM, lambda m: m.__setitem__(123, True)),
    "all": (200, 5, SM, lambda m: m.__setitem__(slice(None), True)),
    "none": (130, 7, SM, lambda m: None),
    "one_rank_range": (512, 12, SM, lambda m: m.__setitem__(slice(0, 40), True)),
    "fewer_than_ranks": (150, 3, SM, lambda m: m.__setitem__([7, 90], True)),
    "d1": (260, 1, SM, lambda m: m.__setitem__(slice(None, None, 5), True)),
    "d512": (70, 512, SM, lambda m: m.__setitem__(slice(0, 50), True)),
    "d513": (90, 513, SM, lambda m: m.__setitem__(slice(20, 90, 3), True)),
    "d2048": (70, 2048, SM, lambda m: m.__setitem__(slice(0, 50), True)),
    "chunks": (20000, 2, 8, lambda m: m.__setitem__(slice(8000, 8400), True)),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_matches_plain(case):
    n, d, sm, fill = MODEL_CASES[case]
    feats, mask = _pool(40 + n, n, d, fill)
    plan = pairwise.launch_plan(n, d, sm)
    got, visited = _model_kernel(feats, mask, plan)
    ref = pairwise.min_distance_to_centers_plain(torch.from_numpy(feats), torch.from_numpy(mask))
    # The plain version's cancellation floor grows with |x|^2 (about 500 at
    # d = 512): atol is 8 ulps of the largest squared norm after the sqrt,
    # chip_smoke.py's bar for the kernel, where that exceeds TOL's.
    atol = max(TOL["atol"], float(np.sqrt(8 * 2.0**-23 * (feats.astype(np.float64) ** 2).sum(1).max())))
    np.testing.assert_allclose(got, ref.numpy(), rtol=TOL["rtol"], atol=atol)
    if not mask.any():
        assert np.isinf(got).all()
    assert (got[mask] == 0).all()  # the same chains for |x|^2, |c|^2 and x.c
    # Each (feature piece, center) pair in exactly one rank, once.
    want = sorted((p, c) for p in range(plan.k_steps) for c in np.flatnonzero(mask).tolist())
    for rb in range(plan.row_blocks):
        per_rank = [visited[(rb, r)] for r in range(plan.cluster)]
        assert sorted(sum(per_rank, [])) == want


@pytest.mark.parametrize("count", [0, 1, 3, 7, 8, 200, 2048, 8191])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_rank_slices_partition_the_centers(count, cluster):
    slices = [pairwise.rank_slice(count, cluster, r) for r in range(cluster)]
    assert slices[0][0] == 0 and slices[-1][1] == count
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    sizes = [hi - lo for lo, hi in slices]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n", [1, 31, 2047, 2048, 16384, 100000])
@pytest.mark.parametrize("d", [1, 57, 512, 513, 2047, 2048, 4096])
@pytest.mark.parametrize("sm", [1, 132])
def test_launch_plan_fits(n, d, sm):
    plan = pairwise.launch_plan(n, d, sm)
    assert plan.row_blocks * pairwise.ROWS >= n > (plan.row_blocks - 1) * pairwise.ROWS
    assert plan.grid == plan.row_blocks * plan.cluster
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.cluster == 1 or plan.grid <= pairwise.CTAS_PER_SM * sm
    assert plan.smem_bytes <= pairwise.SMEM_BLOCK
    assert plan.center_tile == pairwise.TILE == pairwise.WARPS * pairwise.GROUP
    assert plan.tile_stride % 4 == 0 and plan.tile_stride >= plan.center_tile
    assert plan.chunk % pairwise.SCAN == 0 and plan.chunk <= pairwise.MASK_CHUNK
    assert plan.k_width == min(d, pairwise.K_WIDTH)
    assert plan.k_steps == -(-d // plan.k_width)  # the C entry point's check


def test_launch_plan_at_bench_width():
    plan = pairwise.launch_plan(2048, 57, SM)
    assert (plan.row_blocks, plan.cluster, plan.grid) == (64, 4, 256)
    assert plan.center_tile == pairwise.TILE and plan.chunk == pairwise.SCAN
    assert (plan.k_width, plan.k_steps) == (57, 1)  # rows staged once, whole
    big = pairwise.launch_plan(16384, 57, SM)
    assert (big.row_blocks, big.cluster, big.chunk) == (512, 1, pairwise.MASK_CHUNK)
    assert 4 * (big.smem_bytes + 1024) <= 233472  # four CTAs fit an SM


@pytest.mark.parametrize("d", [513, 2047, 2048, 4096])
def test_feature_pieces_cover_the_axis_once(d):
    """The chunked walk: pieces of K_WIDTH floats, k ascending, covering
    [0, d) once; shared memory independent of d; three CTAs fit an SM."""
    plan = pairwise.launch_plan(2048, d, SM)
    pieces = pairwise.k_pieces(plan)
    assert len(pieces) == plan.k_steps and pieces[0][0] == 0 and pieces[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert all(0 < k1 - k0 <= pairwise.K_WIDTH for k0, k1 in pieces)
    assert plan.smem_bytes == pairwise.launch_plan(2048, pairwise.K_WIDTH, SM).smem_bytes
    assert 3 * (plan.smem_bytes + 1024) <= 233472


def test_wide_features_have_no_width_limit():
    """Any width is planned (the TPU kernel takes any d); only d < 1 is refused."""
    assert pairwise.launch_plan(4, 65536, SM).k_steps == 65536 // pairwise.K_WIDTH
    with pytest.raises(ValueError):
        pairwise.launch_plan(4, 0, SM)


def test_c_plan_struct_and_constants_match():
    """csrc/pairwise.cu's ``struct Plan`` has DistancePlan's fields in order,
    and its constants are the plan's."""
    src = open(os.path.join(_build.CSRC, "pairwise.cu")).read()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = [f.strip() for decl in re.findall(r"long long ([^;]*);", body)
              for f in decl.split(",")]
    assert fields == list(pairwise.DistancePlan._fields)
    assert pairwise.PLAN_LEN == len(fields)
    for name, value in (("kRows", pairwise.ROWS), ("kWarps", pairwise.WARPS),
                        ("kGroup", pairwise.GROUP), ("kMaxCluster", pairwise.MAX_CLUSTER)):
        assert int(re.search(r"%s = (\d+);" % name, src).group(1)) == value
