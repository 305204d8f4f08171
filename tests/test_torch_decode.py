"""K1 (fused heatmap decode): the port's plain version against the JAX
package's Pallas kernel in interpret mode and its plain decode ops.

Tolerances: hard-argmax coordinates and peaks are bit-exact (integer
indices times the stride, and a copied value); soft-argmax coordinates
rtol=1e-4, atol=1e-3, as tests/test_pallas_kernels.py holds the Pallas
kernel (softmax moments summed in another order).

The CUDA kernel cannot run here, so its launch plan is tested directly and
a Python model of the kernel's walk (rows per warp, elements per lane, the
incremental (x, y) steps, the first-index argmax) is held to the plain
version."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_view_active_learning_tpu.ops import heatmap as jax_heatmap
from multi_view_active_learning_tpu.ops.pallas import decode as jax_decode
from multi_view_active_learning_tpu_torch import kernels
from multi_view_active_learning_tpu_torch.kernels import _build, decode
from multi_view_active_learning_tpu_torch.ops import heatmap

SOFT = dict(rtol=1e-4, atol=1e-3)


def _maps(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("m,h,w,stride", [
    (10, 16, 16, 4.0), (3, 8, 8, 1.0), (7, 12, 20, 2.0),
    (6, 5, 7, 4.0), (1, 5, 7, 1.0), (1, 16, 16, 4.0),  # ragged maps, a single row
])
def test_plain_decode_matches_pallas_interpret(m, h, w, stride):
    hm = _maps(m, (m, h, w))
    ref = jax_decode.fused_decode(
        jnp.asarray(hm.reshape(m, -1)), width=w, stride=stride, interpret=True
    )
    got = decode.fused_decode(torch.from_numpy(hm.reshape(m, -1)), w, stride)
    np.testing.assert_array_equal(got["coords"].numpy(), np.asarray(ref["coords"]))
    np.testing.assert_array_equal(got["peak"].numpy(), np.asarray(ref["peak"]))
    np.testing.assert_allclose(got["soft_coords"].numpy(), np.asarray(ref["soft_coords"]), **SOFT)


def test_plain_decode_matches_jax_heatmap_ops():
    hm = _maps(0, (10, 16, 16))
    got = decode.fused_decode(torch.from_numpy(hm.reshape(10, -1)), 16, 4.0)
    ref_coords, ref_peak = jax_heatmap.decode_argmax(jnp.asarray(hm), stride=4.0)
    np.testing.assert_array_equal(got["coords"].numpy(), np.asarray(ref_coords))
    np.testing.assert_array_equal(got["peak"].numpy(), np.asarray(ref_peak))
    ref_soft = jax_heatmap.soft_argmax(jnp.asarray(hm), stride=4.0)
    np.testing.assert_allclose(got["soft_coords"].numpy(), np.asarray(ref_soft), **SOFT)


def test_port_heatmap_ops_match_jax():
    hm = _maps(1, (2, 3, 4, 16, 12))
    valid = np.random.default_rng(1).random((2, 3, 4)) > 0.3
    t_hm, t_valid = torch.from_numpy(hm), torch.from_numpy(valid)
    coords, peak = heatmap.decode_argmax(t_hm, stride=4.0)
    ref_coords, ref_peak = jax_heatmap.decode_argmax(jnp.asarray(hm), stride=4.0)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(ref_coords))
    np.testing.assert_array_equal(peak.numpy(), np.asarray(ref_peak))
    np.testing.assert_allclose(
        heatmap.soft_argmax(t_hm, stride=4.0).numpy(),
        np.asarray(jax_heatmap.soft_argmax(jnp.asarray(hm), stride=4.0)), **SOFT,
    )
    for soft in (False, True):
        np.testing.assert_allclose(
            heatmap.decode_keypoints(t_hm, 4.0, t_valid, soft).numpy(),
            np.asarray(jax_heatmap.decode_keypoints(
                jnp.asarray(hm), 4.0, jnp.asarray(valid), soft)),
            **SOFT,
        )
    kp = np.random.default_rng(2).uniform(0, 16, size=(2, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        heatmap.render_gaussian_heatmaps(torch.from_numpy(kp), 16, 12, 1.5).numpy(),
        np.asarray(jax_heatmap.render_gaussian_heatmaps(jnp.asarray(kp), 16, 12, 1.5)),
        rtol=1e-6, atol=1e-7,
    )


def test_ties_resolve_to_first_index():
    hm = np.full((4, 8 * 8), -1.0, np.float32)
    hm[0] = 0.0  # plateau -> index 0
    hm[1, [5, 40, 63]] = 7.0  # equal maxima -> index 5
    hm[2, [63, 9]] = 2.0  # equal maxima out of order -> index 9
    hm[3, 17] = 3.0
    got = decode.fused_decode(torch.from_numpy(hm), 8, 1.0)
    expected = [[0, 0], [5, 0], [1, 1], [1, 2]]
    np.testing.assert_array_equal(got["coords"].numpy(), np.asarray(expected, np.float32))
    ref = jax_decode.fused_decode(jnp.asarray(hm), width=8, stride=1.0, interpret=True)
    np.testing.assert_array_equal(got["coords"].numpy(), np.asarray(ref["coords"]))


@pytest.mark.parametrize("soft", [False, True])
def test_decode_keypoints_matches_pallas_wrapper(soft):
    hm = _maps(5, (2, 3, 4, 16, 16))
    valid = np.random.default_rng(5).random((2, 3, 4)) > 0.3
    coords, peak = decode.decode_keypoints(
        torch.from_numpy(hm), 4.0, torch.from_numpy(valid), soft, with_peak=True
    )
    ref_coords, ref_peak = jax_decode.decode_keypoints_pallas(
        jnp.asarray(hm), 4.0, jnp.asarray(valid), soft, interpret=True, with_peak=True
    )
    np.testing.assert_allclose(coords.numpy(), np.asarray(ref_coords), **SOFT)
    np.testing.assert_array_equal(peak.numpy(), np.asarray(ref_peak))
    assert (coords.numpy()[~valid] == 0).all()


def test_launch_counter_stays_zero_on_cpu():
    kernels.reset_launch_counts()
    decode.fused_decode(torch.from_numpy(_maps(6, (4, 64))), 8, 4.0)
    decode.decode_keypoints(torch.from_numpy(_maps(6, (1, 2, 3, 8, 8))), 4.0,
                            torch.ones((1, 2, 3), dtype=torch.bool))
    assert kernels.launch_counts()["fused_decode"] == 0


def test_wrapper_checks_inputs_and_has_no_fallback():
    with pytest.raises(TypeError):
        decode.fused_decode(torch.zeros((2, 16), dtype=torch.float64), 4, 1.0)
    with pytest.raises(ValueError):
        decode.fused_decode(torch.zeros((2, 15)), 4, 1.0)
    with pytest.raises(ValueError):
        decode.fused_decode(torch.zeros((2, 4, 4)), 4, 1.0)
    # A tensor on neither the CPU nor a CUDA device reaches no plain version.
    with pytest.raises(RuntimeError):
        decode.fused_decode(torch.zeros((2, 16), device="meta"), 4, 1.0)


# -- the kernel's launch plan and a model of its walk ------------------------

SM = 132  # an H100 SXM


def _argmax_combine(v, i, ov, oi):
    return (ov, oi) if ov > v or (ov == v and oi < i) else (v, i)


def _walk(first, step, width):
    """csrc/decode.cu make_walk: (x0, y0, dx, dy)."""
    return first % width, first // width, step % width, step // width


def _advance(x, y, walk, width):
    x, y = x + walk[2], y + walk[3]
    return (x - width, y + 1) if x >= width else (x, y)


def _model_row(row, width, stride, threads, vec):
    """One row through csrc/decode.cu in float32, thread by thread: the bulk
    path (``vec``: float4s, ``threads`` on the row) or the scalar path (one
    warp); the incremental (x, y) of every value is checked against the
    division it replaces."""
    f = np.float32
    hw = row.size
    parts = []
    for t in range(threads):
        if vec:
            # Pass 1 over the thread's float4 maxima in increasing order; the
            # index is a float4 index until the combine.
            qs = list(range(t, hw // 4, threads))
            best, best_q = f(-np.inf), 2**31 - 1
            for step, q in enumerate(qs):
                m4 = row[4 * q:4 * q + 4].max()
                if step == 0 or m4 > best:
                    best, best_q = m4, q
            parts.append((best, best_q))
        else:
            # The thread's values in increasing order; strictly greater wins.
            idx = list(range(t, hw, threads))
            best, best_i = (row[idx[0]], idx[0]) if idx else (f(-np.inf), 2**31 - 1)
            for i in idx[1:]:
                if row[i] > best:
                    best, best_i = row[i], i
            parts.append((best, best_i))
    peak, peak_i = parts[0]
    for v, i in parts[1:]:
        peak, peak_i = _argmax_combine(peak, peak_i, v, i)
    if vec:  # the first component of the winning float4 equal to the max
        j = int(np.flatnonzero(row[4 * peak_i:4 * peak_i + 4] == peak)[0])
        peak, peak_i = row[4 * peak_i + j], 4 * peak_i + j
    se = sx = sy = f(0.0)
    log2e = f(1.4426950408889634)
    pl = peak * log2e
    for t in range(threads):
        if vec:
            walk = _walk(4 * t, 4 * threads, width)
            x, y = walk[0], walk[1]
            for q in range(t, hw // 4, threads):
                e = [np.exp2(row[4 * q + j] * log2e - pl) for j in range(4)]
                s4 = (e[0] + e[1]) + (e[2] + e[3])
                se += s4
                if width % 4 == 0:
                    for j in range(4):  # the four share y
                        assert (x + j, y) == ((4 * q + j) % width, (4 * q + j) // width)
                    sx += f(x) * s4 + (e[1] + f(2) * e[2] + f(3) * e[3])
                    sy += f(y) * s4
                else:
                    for j in range(4):
                        xj, yj = x + j, y
                        while xj >= width:
                            xj, yj = xj - width, yj + 1
                        assert (xj, yj) == ((4 * q + j) % width, (4 * q + j) // width)
                        sx += e[j] * f(xj)
                        sy += e[j] * f(yj)
                x, y = _advance(x, y, walk, width)
        else:
            walk = _walk(t, threads, width)
            x, y = walk[0], walk[1]
            for i in range(t, hw, threads):
                assert (x, y) == (i % width, i // width)
                e = np.exp2(row[i] * log2e - pl)
                se += e
                sx += e * f(x)
                sy += e * f(y)
                x, y = _advance(x, y, walk, width)
    s = f(stride)
    return np.array([f(peak_i % width) * s, f(peak_i // width) * s, peak,
                     sx / se * s, sy / se * s, 0, 0, 0], np.float32)


def _rows_by_unit(plan):
    """(rows, threads on each row) for every block (bulk) or warp (scalar)."""
    if plan.bulk:
        return [(decode.rows_of_block(plan, b), 32 * plan.warps) for b in range(plan.grid)]
    return [(decode.rows_of_warp(plan, b, w), 32)
            for b in range(plan.grid) for w in range(plan.warps)]


def _model_kernel(hm, width, stride, plan):
    """csrc/decode.cu over all rows."""
    out = np.zeros((plan.m, decode.OUT_COLS), np.float32)
    seen = []
    for rows, threads in _rows_by_unit(plan):
        for r in rows:
            seen.append(r)
            out[r] = _model_row(hm[r], width, stride, threads, bool(plan.bulk))
    assert sorted(seen) == list(range(plan.m)), "a row decoded twice or never"
    return out


@pytest.mark.parametrize("m,h,w,ptr,sm", [
    (9, 16, 16, 0, SM),  # bulk, width % 4 == 0
    (5, 6, 6, 0, SM),  # bulk, width % 4 != 0: a float4 straddles map rows
    (4, 4, 2, 0, SM),  # bulk, width < 4: several map rows in one float4
    (3, 8, 3, 0, 1),  # bulk, width 3, several rows per block
    (6, 5, 7, 0, SM),  # ragged: hw * 4 = 140 is not a multiple of 16
    (4, 3, 3, 0, SM),  # ragged and shorter than a warp
    (5, 16, 16, 4, SM),  # ragged: misaligned base
    (1, 64, 64, 0, SM),  # a single bench-width row, 128 threads on it
    (2, 40, 64, 0, SM),  # 640 float4s over 96 threads: some hold 7, some 6
    (1, 160, 160, 0, SM),  # 6400 float4s over 128 threads: 8 held, the rest re-read
    (40, 8, 8, 0, 2),  # many rows per block
    (300, 2, 3, 4, 1),  # scalar path, many rows per warp
])
def test_kernel_model_matches_plain(m, h, w, ptr, sm):
    hm = _maps(100 + m + h, (m, h * w))
    hm[0, [3, 4]] = hm[0].max() + 1.0  # a tie across two float4s
    if h * w > 32:
        hm[-1, [31, 32]] = hm[-1].max() + 1.0  # a tie across two lanes' spans
    if h * w > 128:
        hm[-1, [127, 128]] = hm[-1].max() + 2.0  # across a warp's 128-element span
    plan = decode.launch_plan(m, h * w, w, h * w, ptr, sm)
    got = _model_kernel(hm, w, 4.0, plan)
    ref = decode.fused_decode_plain(torch.from_numpy(hm), w, 4.0).numpy()
    np.testing.assert_array_equal(got[:, :3], ref[:, :3])
    np.testing.assert_allclose(got[:, 3:5], ref[:, 3:5], **SOFT)
    assert (got[:, 5:] == 0).all()


@pytest.mark.parametrize("m", [1, 7, 131, 2356, 100000])
@pytest.mark.parametrize("sm", [1, 132])
@pytest.mark.parametrize("hw", [35, 4096, 3072, 65536])
def test_launch_plan_covers_every_row_once_and_fits(m, sm, hw):
    plan = decode.launch_plan(m, hw, 64 if hw % 64 == 0 else 7, hw, 0, sm)
    rows = [r for unit, _ in _rows_by_unit(plan) for r in unit]
    assert sorted(rows) == list(range(m))
    assert 1 <= plan.warps <= (decode.BULK_WARPS if plan.bulk else decode.RAGGED_WARPS)
    assert plan.smem_bytes + decode.STATIC_SMEM <= decode.SMEM_BLOCK
    per_sm = -(-plan.grid // sm)
    if not plan.bulk:
        assert per_sm * plan.warps <= decode.WARPS_SM and per_sm <= decode.BLOCKS_SM
    if plan.bulk:
        resident = -(-per_sm // decode.WAVES)
        assert resident * (plan.smem_bytes + decode.STATIC_SMEM + 1024) <= decode.SMEM_SM
        assert plan.smem_bytes == 4 * hw and plan.smem_bytes % 16 == 0  # one staged row
        shares = [len(decode.rows_of_block(plan, b)) for b in range(plan.grid)]
        assert max(shares) - min(shares) <= 1  # equal shares


@pytest.mark.parametrize("hw,ptr,row_stride,bulk", [
    (4096, 0, 4096, True),  # the bench rows
    (4096, 16, 4096, True),
    (4096, 4, 4096, False),  # misaligned base (x[:, 1:] of a [m, 4097] tensor)
    (4096, 0, 4097, False),  # rows 16388 bytes apart: misaligned from row 1 on
    (35, 0, 35, False),  # 5 x 7 maps: 140 bytes a row
    (36, 0, 36, True),  # 6 x 6 maps: 144 bytes
    (2, 0, 2, False),
    (4, 0, 4, True),
    (36864, 0, 36864, True),  # a staged row fits one block
    (58112, 0, 58112, False),  # it does not
])
def test_launch_plan_bulk_or_ragged(hw, ptr, row_stride, bulk):
    plan = decode.launch_plan(50, hw, 1, row_stride, ptr, SM)
    assert bool(plan.bulk) == bulk
    assert plan.smem_bytes == (4 * hw if bulk else 0)


def test_launch_plan_at_bench_width():
    plan = decode.launch_plan(2356, 4096, 64, 4096, 0, SM)
    assert plan.bulk and plan.warps == 4  # 8 float4s a thread
    assert plan.smem_bytes == 16384 and plan.grid == 2356  # one row a block
    big = decode.launch_plan(100000, 4096, 64, 4096, 0, SM)
    assert big.grid == SM * decode.BULK_MIN_BLOCKS * decode.WAVES  # 3 rounds of 6 a SM


def test_c_plan_struct_and_constants_match():
    """csrc/decode.cu's ``struct Plan`` has DecodePlan's fields in order, and
    its constants are the plan's."""
    src = open(os.path.join(_build.CSRC, "decode.cu")).read()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = [f.strip() for decl in re.findall(r"long long ([^;]*);", body)
              for f in decl.split(",")]
    assert fields == list(decode.DecodePlan._fields)
    assert decode.PLAN_LEN == len(fields)
    for name, value in (("kBulkWarps", decode.BULK_WARPS), ("kRaggedWarps", decode.RAGGED_WARPS),
                        ("kHeld", decode.HELD), ("kBulkMinBlocks", decode.BULK_MIN_BLOCKS)):
        assert int(re.search(r"%s = (\d+);" % name, src).group(1)) == value
