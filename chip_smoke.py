#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multi_view_active_learning_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card (K1 decode at bench width and on its ragged, misaligned and one-row
shapes; K2 coreset distance on the bench pool, its edge cases, feature
widths 1 to 2048 (bit for bit on exact grids at 512, 2047 and 2048), a
16384-row pool and the 2048 x 2048 EMBEDDING pool; K3 / K4 fused deconv head
at the head's three bench-width shapes), checks the card's int8
convolutions against the CPU's, PoseResNet-50 and HRNet-W32 against the
stored forward goldens and a full-width triangulation against ground truth,
then drives the active-learning scoring pass at the width of ``bench.py``
(B=4 frames, V=31 views, 256x256 crops, K=19 joints, 64 RANSAC pairs)
through ``Engine.score_step``: PoseResNet-50 in bfloat16 and float32 with
``Engine.eval_step`` and the coreset ranking, then the int8 backbone (the
default configuration) with the bf16 head and with K4, the bf16 float path
with K3; HRNet-W32 in bf16 for TRIANGULATION, MPE, HP, BSB (AVG and STD)
and AL.DIRECT_OPTIMIZATION, its uncertainty metrics on the card against the
CPU, and its int8 path (TPU.INT8_SCORING_HRNET); and PoseResNet-50's CORESET
with AL.CORESET_FEATURES=EMBEDDING, whose k-center picks on a 2048 x 2048
pool must equal the plain CPU run's.  Last, the pool sweep and the AL step
through ``ActiveLearningStrategy`` (``phase_pool_sweep``): on the golden
tree the card's sal_dict and guid logs equal the CPU's and the reference's
goldens (it prints whether the tree matched theirs), and so do CORESET
steps on POSE and EMBEDDING features; then bench.py's 64-frame x 31-view
pool with decode workers prints cold, warm and bare-step frames/s, holds
the warm sweep's sal_dict to the cold one's and to the bare steps', and K2
to its plain version on a full-width CORESET step's own features.  The
kernels' launch counters are set to 0 before each path and read after it;
the ``kernels`` line also gives K1's launches in a warm sweep and K2's in
the full-width CORESET step (``sweep_launches``).

Prints one JSON line per phase, the card's name and power limit as
nvidia-smi reports them, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
nonzero; without a CUDA device it exits nonzero and prints no result.
Before the last lines, and on any failure, it stops every process it
started (decode workers, their forkserver, multiprocessing's resource
tracker) and waits for them; a child still alive then fails the run.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "fixtures", "model_forward_goldens.npz")

# Main-path shape (bench.py:41-56).
BATCH, VIEWS, IMG, JOINTS, DEPTH = 4, 31, 256, 19, 50
POOL, POOL_DIM, LABELED, PICK = 2048, 3 * JOINTS, 200, 100
# AL.CORESET_FEATURES=EMBEDDING: pooled trunk features, PoseResNet-50's
# 2048 channels and HRNet-W32's 32.
EMBED_DIM, HRNET_EMBED_DIM = 2048, 32

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory, the
# FP32 rate outside the tensor cores (K1, K2), the bf16 and int8 tensor-core
# rates (K3, K4).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
SPIN_BATCH_CYCLES = 20_000_000  # about 10 ms: the host enqueues a batch meanwhile (rotated_ms)
L2_BYTES = 50 * 2**20

# The deconv head's three layers at the main path's width, NHWC
# (crops, H, W, Cin, Cout): PoseResNet-50's 2048-channel trunk at 8x8.
CROPS = BATCH * VIEWS
HEAD_SHAPES = [(CROPS, 8, 8, 2048, 256), (CROPS, 16, 16, 256, 256), (CROPS, 32, 32, 256, 256)]
# Checked, not timed: Cin=640 (not a multiple of the TPU kernel's 256-wide
# chunk) and a small ragged case (Cin=72 leaves a partial K tile; 5x7 maps
# and 64 channels leave partial pixel and channel tiles).
EXTRA_HEAD_SHAPES = [(CROPS, 8, 8, 640, 256), (6, 5, 7, 72, 64)]

# Tolerances of kernel against plain version.
K1_SOFT_RTOL, K1_SOFT_ATOL = 1e-4, 1e-3  # softmax moments, summed in another order
# K2: the plain version's |x|^2 + |c|^2 - 2 x.c cancels to a rounding floor
# of a few ulps of the largest squared norm, which a labeled point's zero
# distance to itself shows after the sqrt (the kernel, summing all three
# terms in one FMA order, gets exactly 0 there).  atol is that floor at 8 ulps.
K2_RTOL = 1e-3
GT_MEAN_TOL, GT_MAX_TOL = 2.0, 5.0  # world units; stride-4 argmax quantization
# K3 / K4 against their plain versions, on bf16 outputs: one bf16 rounding
# step (2^-7 relative) where the float32 sums, taken in another order, land
# on the other side of a rounding boundary, plus 1e-4 of the output scale
# for values near the ReLU's zero.  K3 in float32: rtol 1e-4 and 1e-4 of
# the scale (sums over up to 4 x 2048 terms in another order).  K4's s32
# sums are exact and its epilogue is the plain version's, so it is held to
# the same bf16 bar and its measured error is printed.
HEAD_RTOL, HEAD_ATOL_OF_SCALE = 2.0**-7, 1e-4
HEAD_F32_RTOL = 1e-4
# Int8 paths against the float bf16 heatmaps: the JAX package's bar for
# int8 against float (tests/test_quantize.py:33-39), cosine > 0.99 and
# per-map argmax agreement > 0.8, set there on 64x64 crops of a random-
# weight net with dynamic scales; it is applied at that input size (the
# 64x64 maps of 256x256 crops of a random-weight net are tie-prone: even
# bf16 against float32 float agrees on only about 0.9 of their argmaxes,
# so at bench width the agreement is printed beside that floor and the
# cosine bar holds).  The K3 path against the standard bf16 head: max error
# <= 0.05 of the scale, cosine > 0.999.
INT8_COS, INT8_ARGMAX_AGREE, INT8_BAR_IMG = 0.99, 0.8, 64
K3_PATH_MAX_ERR, K3_PATH_COS = 0.05, 0.999


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _child_processes():
    """(pid, state, command) of every child of this process, zombies
    included, read from /proc."""
    children = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % pid) as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open("/proc/%s/cmdline" % pid, "rb") as f:
                command = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # exited meanwhile
            continue
        if int(fields[1]) == os.getpid():
            children.append((int(pid), fields[0], command[:120]))
    return children


def stop_child_processes(timeout_s=30.0):
    """Stop every process this run started and wait for it: the decode
    workers and their forkserver, then multiprocessing's resource tracker,
    which exits once nothing holds its pipe.  A child still alive after
    `timeout_s` is killed and returned, so that the run fails instead of
    leaving it behind."""
    import signal

    pipeline = sys.modules.get("multi_view_active_learning_tpu_torch.data.pipeline")
    if pipeline is not None:
        pipeline.stop_decode_processes()
    tracker = sys.modules.get("multiprocessing.resource_tracker")
    if tracker is not None and tracker._resource_tracker._fd is not None:
        # ResourceTracker._stop without its unbounded wait: closing the
        # pipe asks the tracker to exit; the loop below reaps it.
        os.close(tracker._resource_tracker._fd)
        tracker._resource_tracker._fd = tracker._resource_tracker._pid = None
    deadline = time.monotonic() + timeout_s
    left = _child_processes()
    while left and time.monotonic() < deadline:
        try:
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        except ChildProcessError:
            pass
        time.sleep(0.05)
        left = _child_processes()
    for pid, _, _ in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    return left


def golden_fill_values(names, shapes, seed):
    """Deterministic weights that keep eval-mode activations O(1) through
    the whole network: conv ~ N(0, 1/sqrt(fan_in)), BN scale ~ U(0.8, 1.2),
    running_var ~ U(0.5, 1.5).  The same generator built the stored forward
    goldens (tests/helpers.py keeps the tests' copy)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in zip(names, shapes):
        shape = tuple(int(s) for s in shape)
        if name.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, size=shape)
        elif name.endswith("running_mean"):
            arr = rng.normal(0.0, 0.1, size=shape)
        elif name.endswith("bias"):
            arr = rng.normal(0.0, 0.05, size=shape)
        elif len(shape) == 1:
            arr = rng.uniform(0.8, 1.2, size=shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            arr = rng.normal(0.0, 1.0 / np.sqrt(fan_in), size=shape)
        out[name] = arr.astype(np.float32)
    return out


def make_ring_cameras(num_views, radius=300.0, img=256, focal=260.0, jitter=0.1):
    """Cameras on a ring looking at the origin; returns [V, 3, 4] projections."""
    from multi_view_active_learning_tpu_torch.ops.geometry import Camera

    projs = []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views + jitter
        pos = np.array(
            [radius * np.cos(ang), 50.0 + 10 * np.sin(3 * ang), radius * np.sin(ang)]
        )
        z = -pos / np.linalg.norm(pos)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        K = np.array([[focal, 0, img / 2], [0, focal, img / 2], [0, 0, 1.0]])
        projs.append(Camera(R, -R @ pos, K).projection)
    return np.stack(projs).astype(np.float32)


def random_state_dict(model, seed):
    """Seeded O(1)-activation weights for every parameter and statistic."""
    import torch

    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    values = golden_fill_values(list(shapes), list(shapes.values()), seed)
    return {k: torch.from_numpy(v) for k, v in values.items()}


def cuda_ms(fn, iters, flush=None, warmup=2):
    """Median device time of fn over `iters` launches, from CUDA events
    around each launch; `flush` (a large buffer) is rewritten before each
    launch so the inputs come from device memory, not L2.  Every kernel's
    `ms`."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def rotated_ms(fn, inputs, iters=20, reps=3):
    """Device time per launch of fn(*inputs[i % len(inputs)]) over `iters`
    back-to-back launches, the median of `reps` batches.  The inputs are
    copies (`rotation`) that together exceed the L2, so each launch reads
    its input from device memory, and no line in L2 is dirty.  A batch is
    queued behind a spin of the card, so neither the host's enqueue time nor
    a launch's own latency on an idle card enters; CUDA events at its ends.
    Printed beside K1's and K2's `ms`, whose launches last microseconds."""
    import torch

    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_BATCH_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def rotation(*tensors):
    """Copies of `tensors`, enough that together they hold twice the L2; a
    view's copy keeps its strides and its offset from an aligned base."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    out = []
    for _ in range(max(2, -(-2 * L2_BYTES // nbytes) + 1)):
        copies = []
        for t in tensors:
            span = t.storage_offset() + sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1
            c = torch.as_strided(torch.empty(span, dtype=t.dtype, device=t.device),
                                 t.shape, t.stride(), t.storage_offset())
            copies.append(c.copy_(t))
        out.append(tuple(copies))
    return out


def phase_device():
    import torch
    from multi_view_active_learning_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    seconds, log = _build.build()
    _build.load_library()
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=seconds, ptxas=ptxas)
    return smi


def _k1_check(decode, x, w, stride, tag):
    """K1 against its plain version on x: hard argmax and peak bit for bit,
    soft-argmax within rtol / atol.  Returns (result, max |soft error|)."""
    import torch

    got = decode.fused_decode(x, w, stride)
    ref = decode.fused_decode_plain(x, w, stride)
    torch.cuda.synchronize()
    hard_err = float(torch.max(torch.abs(got["coords"] - ref[:, 0:2])))
    peak_err = float(torch.max(torch.abs(got["peak"] - ref[:, 2])))
    soft_err = torch.abs(got["soft_coords"] - ref[:, 3:5])
    check(hard_err == 0.0 and peak_err == 0.0, "K1 %s: hard argmax / peak differ from plain" % tag)
    check(bool(torch.all(soft_err <= K1_SOFT_ATOL + K1_SOFT_RTOL * torch.abs(ref[:, 3:5]))),
          "K1 %s: soft-argmax outside rtol %g atol %g" % (tag, K1_SOFT_RTOL, K1_SOFT_ATOL))
    return got, float(soft_err.max())


def _k1_plan(decode, x, w):
    plan = decode.plan_for(x, w)
    return dict(m=plan.m, grid=plan.grid, warps=plan.warps, bulk=plan.bulk,
                smem_bytes=plan.smem_bytes)


def phase_k1(dev, flush):
    """K1 against its plain version on the main path's [B*V*K, 64*64] rows
    (timed; tie rows: a plateau, equal maxima, maxima out of order, and
    ties across two float4s and across a warp's 128-value span), then on
    the kernel's other paths: 5x7 maps (140-byte rows), the misaligned view
    x[:, 1:] of [M, 4097] rows (timed), a single row, twice the bench rows
    (blocks of two rows: the stage refilled, the mbarrier's parity turning)
    and 128x128 maps (a row longer than the registers hold: pass 2 reads
    the stage again; several rows a block; ties past the held part).  `ms`
    is one launch after an L2 flush (cuda_ms); `rotated_ms` is printed
    beside it."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import decode

    m, h, w = BATCH * VIEWS * JOINTS, IMG // 4, IMG // 4
    rng = np.random.default_rng(1)
    hm = (rng.normal(size=(m, h * w)) * 3).astype(np.float32)
    hm[0] = 0.0  # a plateau: the first index wins
    hm[1, [5, 900, 4000]] = 50.0  # three equal maxima
    hm[2] = -1.0
    hm[2, [4095, 17]] = 2.0
    hm[3, [4, 3]] = 40.0  # indices 3 and 4 lie in two float4s
    hm[4, [128, 127]] = 40.0  # 127 ends lane 31's first float4, 128 starts lane 0's second
    x = torch.from_numpy(hm).to(dev)
    stride = 4.0
    got, soft_err = _k1_check(decode, x, w, stride, "bench rows")
    ties = got["coords"][:5].cpu().numpy().tolist()
    check(ties == [[0.0, 0.0], [20.0, 0.0], [68.0, 0.0], [12.0, 0.0], [252.0, 4.0]],
          "K1 tie rows: %s" % ties)
    plans = {"bench": _k1_plan(decode, x, w)}
    check(plans["bench"]["bulk"] == 1, "K1 bench rows must take the bulk path")

    wide = torch.from_numpy((rng.normal(size=(m, h * w + 1)) * 3).astype(np.float32)).to(dev)
    misaligned = wide[:, 1:]
    ragged = torch.from_numpy((rng.normal(size=(m, 35)) * 3).astype(np.float32)).to(dev)
    single = x[5:6]
    gen = torch.Generator(device=dev).manual_seed(1)
    doubled = torch.cat([x, torch.randn((m, h * w), generator=gen, device=dev) * 3])
    big_w = 2 * w
    big = torch.randn((m, big_w * big_w), generator=gen, device=dev) * 3
    big[0] = 0.0
    big[1, [9000, 4100, 12000]] = 50.0  # equal maxima, all past the held 4096 values
    big[2, [4095, 9000]] = 50.0  # one held, one re-read from the stage
    extra = {}
    for tag, xe, we in (("hw35", ragged, 7), ("misaligned", misaligned, w), ("m1", single, w),
                        ("two_rows_a_block", doubled, w), ("hw16384", big, big_w)):
        got_e, extra[tag] = _k1_check(decode, xe, we, stride, tag)
        plans[tag] = _k1_plan(decode, xe, we)
        if tag == "hw16384":
            ties_big = got_e["coords"][:3].cpu().numpy().tolist()
            check(ties_big == [[0.0, 0.0], [16.0, 128.0], [508.0, 124.0]],
                  "K1 hw16384 tie rows: %s" % ties_big)
    check(plans["hw35"]["bulk"] == 0 and plans["misaligned"]["bulk"] == 0
          and plans["m1"]["bulk"] == 1, "K1 bulk / ragged choice: %s" % plans)
    for tag in ("two_rows_a_block", "hw16384"):
        check(plans[tag]["bulk"] == 1 and plans[tag]["grid"] < plans[tag]["m"],
              "K1 %s must take the bulk path with several rows a block: %s" % (tag, plans[tag]))

    ms = cuda_ms(lambda: decode.fused_decode(x, w, stride), 20, flush)
    plain_ms = cuda_ms(lambda: decode.fused_decode_plain(x, w, stride), 20, flush)
    ragged_ms = cuda_ms(lambda: decode.fused_decode(misaligned, w, stride), 20, flush)
    rot = rotation(x)
    rot_ms = rotated_ms(lambda t: decode.fused_decode(t, w, stride), rot)
    rot_plain_ms = rotated_ms(lambda t: decode.fused_decode_plain(t, w, stride), rot)
    nbytes = m * h * w * 4 + m * decode.OUT_COLS * 4
    ops = 8 * m * h * w  # max, subtract, exp, add, two FMAs per element
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    row = dict(name="fused_decode", route="cuda",
               source="multi_view_active_learning_tpu_torch/csrc/decode.cu",
               replaces="multi_view_active_learning_tpu/ops/pallas/decode.py:68",
               max_abs_err=max(soft_err, *extra.values()),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations",
               library_ms=None)
    emit("k1", shape=[m, h * w], hard_err=0.0, peak_err=0.0, soft_err=soft_err,
         extra_soft_err=extra, plans=plans, ms=ms, ragged_path_ms=ragged_ms,
         plain_ms=plain_ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
         rotated_ms=rot_ms, rotated_plain_ms=rot_plain_ms,
         rotated_share_of_bound=bound_ms / rot_ms, ptxas=_ptxas("decode.cu"))
    return row


def _k2_bound_ms(n, d, centers):
    """(bound ms, "bytes" or "operations") of K2 on a [n, d] pool with
    `centers` centers: x, mask and output moved once; 2 d + 3 operations
    per (row, center) pair."""
    nbytes = n * d * 4 + n + n * 4
    ops = 2 * n * centers * d + 3 * n * centers
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def _k2_check(pairwise, feats, mask, tag, float64_ref=False):
    """K2 against its plain version within K2_RTOL and 8 ulps of the largest
    squared norm (after the sqrt); labeled points at exactly 0.  With
    `float64_ref` the plain version runs in float64: at d = 2048 its own
    float32 cancellation floor (a labeled point about 0.08 off its center)
    exceeds the 8-ulp bar that the kernel, whose self-distances are exactly
    0, is held to."""
    import torch

    got = pairwise.min_distance_to_centers(feats, mask)
    if float64_ref:
        ref = pairwise.min_distance_to_centers_plain(feats.double(), mask).float()
    else:
        ref = pairwise.min_distance_to_centers_plain(feats, mask)
    torch.cuda.synchronize()
    atol = float(torch.sqrt(8 * 2.0**-23 * torch.max(torch.sum(feats * feats, dim=-1))))
    err = float(torch.max(torch.abs(got - ref))) if bool(mask.any()) else 0.0
    check(bool(torch.allclose(got, ref, rtol=K2_RTOL, atol=atol)),
          "K2 %s differs from plain: %g (atol %g)" % (tag, err, atol))
    if bool(mask.any()):
        check(float(got[mask].max()) == 0.0, "K2 %s: a labeled point is off its own center" % tag)
    return got, err


def phase_k2(dev, flush):
    """K2 against its plain version on the coreset ranking's pool (timed),
    then: no centers (inf), scattered centers, n = 2047, d = 1, 32 (HRNet's
    embedding), 512, 2047 and 2048 (the feature axis walked in pieces),
    every row labeled, one center (all centers in one rank's slice), the
    centers in one block of n / cluster rows (what a split by row range
    would give one rank), a 16384 x 57 pool with 2048 contiguous labeled
    rows and the 2048 x 2048 EMBEDDING pool of PoseResNet-50 with 200
    labeled rows (both timed, with their shares of the bound).  On the
    quarters grids (d = 512, 2047, 2048) every sum is exact, so the kernel
    must equal the plain version bit for bit there.  `ms` is one launch
    after an L2 flush (cuda_ms); `rotated_ms` is printed beside it."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import _build, pairwise

    rng = np.random.default_rng(2)
    sms = _build.sm_count(dev)
    feats = torch.from_numpy(rng.normal(size=(POOL, POOL_DIM)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(np.arange(POOL) >= POOL - LABELED).to(dev)
    got, err = _k2_check(pairwise, feats, mask, "bench pool")
    none = pairwise.min_distance_to_centers(feats, torch.zeros_like(mask))
    torch.cuda.synchronize()
    check(bool(torch.all(torch.isinf(none))), "K2 without centers must give inf")
    plan = pairwise.launch_plan(POOL, POOL_DIM, sms)
    sparse = torch.zeros_like(mask)
    sparse[::97] = True  # centers scattered over many tiles
    one = torch.zeros_like(mask)
    one[777] = True
    block = torch.zeros_like(mask)
    block[:POOL // plan.cluster] = True
    cases = {
        "scattered": (feats, sparse),
        "n2047": (feats[:POOL - 1], mask[:POOL - 1]),
        "all_labeled": (feats, torch.ones_like(mask)),
        "one_center": (feats, one),
        "one_row_range": (feats, block),
    }
    cases["d1"] = (torch.from_numpy(rng.normal(size=(POOL, 1)).astype(np.float32)).to(dev), mask)
    cases["d%d" % HRNET_EMBED_DIM] = (torch.from_numpy(
        rng.normal(size=(POOL, HRNET_EMBED_DIM)).astype(np.float32)).to(dev), mask)
    # Grids of quarters in [-2, 2]: every square, product and sum is exact in
    # float32, so the plain version's own rounding, which grows with d past
    # the 8-ulp bar, does not enter the comparison, and the two must be equal.
    exact = ("d512", "d2047", "d2048")
    for tag in exact:
        quarters = rng.integers(-8, 9, size=(POOL, int(tag[1:]))).astype(np.float32) / 4
        cases[tag] = (torch.from_numpy(quarters).to(dev), mask)
    errs, self_dist, k_plans = {}, {}, {}
    for tag, (f, mk) in cases.items():
        got_c, errs[tag] = _k2_check(pairwise, f, mk, tag)
        self_dist[tag] = float(got_c[mk].max()) if bool(mk.any()) else None
        if tag in exact:
            ref_c = pairwise.min_distance_to_centers_plain(f, mk)
            check(torch.equal(got_c, ref_c), "K2 %s: not bit-equal to plain on an exact grid" % tag)
            wp = pairwise.launch_plan(POOL, f.shape[1], sms)
            k_plans[tag] = dict(k_width=wp.k_width, k_steps=wp.k_steps, smem_bytes=wp.smem_bytes)

    ms = cuda_ms(lambda: pairwise.min_distance_to_centers(feats, mask), 50, flush)
    plain_ms = cuda_ms(lambda: pairwise.min_distance_to_centers_plain(feats, mask), 50, flush)
    rot = rotation(feats, mask)
    rot_ms = rotated_ms(pairwise.min_distance_to_centers, rot, iters=50)
    centers = int(mask.sum())
    bound_ms, bound_by = _k2_bound_ms(POOL, POOL_DIM, centers)

    big_n, big_labeled = 16384, 2048
    big = torch.from_numpy(rng.normal(size=(big_n, POOL_DIM)).astype(np.float32)).to(dev)
    big_mask = torch.from_numpy(np.arange(big_n) >= big_n - big_labeled).to(dev)
    _, errs["n16384"] = _k2_check(pairwise, big, big_mask, "16384 pool")
    big_ms = cuda_ms(lambda: pairwise.min_distance_to_centers(big, big_mask), 20, flush)
    big_plain_ms = cuda_ms(lambda: pairwise.min_distance_to_centers_plain(big, big_mask), 5, flush)
    big_rot_ms = rotated_ms(pairwise.min_distance_to_centers, rotation(big, big_mask))
    big_bound_ms, big_bound_by = _k2_bound_ms(big_n, POOL_DIM, big_labeled)
    big_plan = pairwise.launch_plan(big_n, POOL_DIM, sms)

    # The EMBEDDING pool: PoseResNet-50's pooled trunk features.
    emb = torch.from_numpy(rng.normal(size=(POOL, EMBED_DIM)).astype(np.float32)).to(dev)
    _, errs["embedding"] = _k2_check(pairwise, emb, mask, "embedding pool", float64_ref=True)
    emb_plan = pairwise.launch_plan(POOL, EMBED_DIM, sms)
    emb_bound_ms, emb_bound_by = _k2_bound_ms(POOL, EMBED_DIM, centers)
    emb_ms = cuda_ms(lambda: pairwise.min_distance_to_centers(emb, mask), 20, flush)
    emb_plain_ms = cuda_ms(lambda: pairwise.min_distance_to_centers_plain(emb, mask), 10, flush)
    emb_rot_ms = rotated_ms(pairwise.min_distance_to_centers, rotation(emb, mask))

    row = dict(name="min_distance_to_centers", route="cuda",
               source="multi_view_active_learning_tpu_torch/csrc/pairwise.cu",
               replaces="multi_view_active_learning_tpu/ops/pallas/pairwise.py:63",
               max_abs_err=max(err, *errs.values()),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    emit("k2", shape=[POOL, POOL_DIM], centers=centers, max_abs_err=row["max_abs_err"],
         case_errs=errs, rtol=K2_RTOL, labeled_self_distance=float(got[-LABELED:].max()),
         labeled_self_distance_by_case=self_dist, bit_equal_on_exact_grids=list(exact),
         k_plans=k_plans,
         embedding=dict(shape=[POOL, EMBED_DIM], centers=centers, ms=emb_ms, plain_ms=emb_plain_ms,
                        rotated_ms=emb_rot_ms, bound_ms=emb_bound_ms, bound_by=emb_bound_by,
                        share_of_bound=emb_bound_ms / emb_ms,
                        rotated_share_of_bound=emb_bound_ms / emb_rot_ms,
                        k_width=emb_plan.k_width, k_steps=emb_plan.k_steps,
                        cluster=emb_plan.cluster, grid=emb_plan.grid,
                        smem_bytes=emb_plan.smem_bytes),
         cluster=dict(rows_per_cluster=pairwise.ROWS, row_blocks=plan.row_blocks,
                      cluster=plan.cluster, grid=plan.grid, center_tile=plan.center_tile,
                      smem_bytes=plan.smem_bytes),
         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
         rotated_ms=rot_ms, rotated_share_of_bound=bound_ms / rot_ms,
         large=dict(shape=[big_n, POOL_DIM], centers=big_labeled, ms=big_ms,
                    plain_ms=big_plain_ms, bound_ms=big_bound_ms, bound_by=big_bound_by,
                    share_of_bound=big_bound_ms / big_ms, rotated_ms=big_rot_ms,
                    cluster=dict(row_blocks=big_plan.row_blocks, cluster=big_plan.cluster,
                                 grid=big_plan.grid, center_tile=big_plan.center_tile,
                                 smem_bytes=big_plan.smem_bytes)),
         ptxas=_ptxas("pairwise.cu"))
    return row


def _head_inputs(shape, dtype, dev, seed):
    """Seeded inputs of one head layer: post-ReLU x NHWC, a [Cin, Cout, 4, 4]
    weight scaled for O(1) outputs, and the folded BN (scale, bias) with
    its raw statistics."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import deconv

    n, h, w, cin, cout = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn((n, h, w, cin), generator=gen, device=dev)).to(dtype)
    weight = torch.randn((cin, cout, 4, 4), generator=gen, device=dev) / float(np.sqrt(4 * cin))
    gamma = torch.rand(cout, generator=gen, device=dev) + 0.5
    beta = torch.randn(cout, generator=gen, device=dev) * 0.1
    mean = torch.randn(cout, generator=gen, device=dev) * 0.1
    var = torch.rand(cout, generator=gen, device=dev) + 0.5
    scale, bias = deconv.fold_bn(gamma, beta, mean, var)
    return x, weight, scale, bias, (gamma, beta, mean, var)


def _head_err(got, ref, rtol, atol_of_scale):
    """(max |got - ref|, max |ref|, whether |got - ref| <= rtol |ref| +
    atol_of_scale max |ref| everywhere)."""
    import torch

    got, ref = got.float(), ref.float()
    scale = float(torch.max(torch.abs(ref)))
    err = torch.abs(got - ref)
    ok = bool(torch.all(err <= rtol * torch.abs(ref) + atol_of_scale * scale))
    return float(err.max()), scale, ok


def _head_bound(shape, x_bytes, w_bytes, peak):
    """(bytes-bound ms, operations-bound ms) of one head layer: x, weights
    and BN read once, the output written once; 16 MACs per input pixel,
    input channel and output channel."""
    n, h, w, cin, cout = shape
    nbytes = n * h * w * cin * x_bytes + cin * cout * 16 * w_bytes + 4 * n * h * w * cout * x_bytes + 8 * cout
    ops = 2 * 16 * n * h * w * cin * cout
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


def _head_row(name, source, replaces, per_shape, library_ms):
    bytes_ms = sum(e["bound_bytes_ms"] for e in per_shape)
    ops_ms = sum(e["bound_ops_ms"] for e in per_shape)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max(e["max_abs_err"] for e in per_shape),
                ms=sum(e["ms"] for e in per_shape), plain_ms=sum(e["plain_ms"] for e in per_shape),
                bound_ms=sum(max(e["bound_bytes_ms"], e["bound_ops_ms"]) for e in per_shape),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=library_ms)


def _ptxas(source):
    """The -Xptxas -v lines of one source from the build log: per kernel,
    its registers, shared memory and spills."""
    from multi_view_active_learning_tpu_torch.kernels import _build

    with open(os.path.join(_build.BUILD_DIR, "build.log")) as f:
        text = f.read()
    section = text.split("== %s\n" % source, 1)[-1].split("\n== ", 1)[0]
    out, kernel = [], None
    for line in section.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("Used" in line or "spill" in line):
            out.append("%s: %s" % (kernel, line.split(":", 1)[-1].strip() if "Used" in line else line.strip()))
    return out


def _share(e):
    return max(e["bound_bytes_ms"], e["bound_ops_ms"]) / e["ms"]


def phase_k3(dev, flush):
    """K3 against its plain version at the head's three bench-width shapes
    (bf16, timed) and at the extra shapes (bf16 and float32).  `ms` times the
    kernel alone on packed operands; `wrapper_ms` the wrapper on operands
    packed once (the engine's call path, pack_k3 at weight load);
    `unpacked_wrapper_ms` the public wrapper on raw weights, which packs
    per call.  The yardstick is the standard head's cuDNN ConvTranspose2d +
    BatchNorm + ReLU in bf16 NCHW: three calls."""
    import torch
    import torch.nn.functional as F
    from multi_view_active_learning_tpu_torch.kernels import deconv

    per_shape, f32_errs, library_ms = [], [], 0.0
    for idx, shape in enumerate(HEAD_SHAPES + EXTRA_HEAD_SHAPES):
        x, weight, scale, bias, bn = _head_inputs(shape, torch.bfloat16, dev, 10 + idx)
        got = deconv.fused_deconv_bn_relu(x, weight, scale, bias)
        ref = deconv.fused_deconv_bn_relu_plain(x, weight, scale, bias)
        torch.cuda.synchronize()
        err, sc, ok = _head_err(got, ref, HEAD_RTOL, HEAD_ATOL_OF_SCALE)
        check(ok, "K3 bf16 differs from plain at %s: %g (scale %g)" % (shape, err, sc))
        if idx >= len(HEAD_SHAPES):
            x32 = x.float()
            e32, sc32, ok32 = _head_err(deconv.fused_deconv_bn_relu(x32, weight, scale, bias),
                                        deconv.fused_deconv_bn_relu_plain(x32, weight, scale, bias),
                                        HEAD_F32_RTOL, HEAD_F32_RTOL)
            check(ok32, "K3 float32 differs from plain at %s: %g (scale %g)" % (shape, e32, sc32))
            f32_errs.append(dict(shape=list(shape), bf16_err=err, f32_err=e32, scale=sc))
            continue
        ops = deconv.pack_k3(weight, scale, bias, x.dtype)
        xc, wc = x.permute(0, 3, 1, 2).contiguous(), weight.to(torch.bfloat16)
        gamma, beta, mean, var = bn
        lib = cuda_ms(lambda: torch.relu(F.batch_norm(
            F.conv_transpose2d(xc, wc, stride=2, padding=1), mean, var, gamma, beta, False, 0.0, 1e-5)),
            20, flush)
        library_ms += lib
        b_bytes, b_ops = _head_bound(shape, 2, 2, BF16_OPS_PER_S)
        entry = dict(
            shape=list(shape), max_abs_err=err, scale=sc,
            ms=cuda_ms(lambda: deconv.launch(x, ops), 20, flush),
            wrapper_ms=cuda_ms(lambda: deconv.fused_deconv_bn_relu_packed(x, ops), 20, flush),
            unpacked_wrapper_ms=cuda_ms(
                lambda: deconv.fused_deconv_bn_relu(x, weight, scale, bias), 20, flush),
            plain_ms=cuda_ms(lambda: deconv.fused_deconv_bn_relu_plain(x, weight, scale, bias), 5, flush),
            library_ms=lib, bound_bytes_ms=b_bytes, bound_ops_ms=b_ops)
        entry["share_of_bound"] = _share(entry)
        per_shape.append(entry)
    row = _head_row("fused_deconv_bn_relu", "multi_view_active_learning_tpu_torch/csrc/deconv.cu",
                    "multi_view_active_learning_tpu/ops/pallas/deconv.py:130", per_shape, library_ms)
    emit("k3", per_shape=per_shape, extra=f32_errs, rtol=HEAD_RTOL,
         atol_of_scale=HEAD_ATOL_OF_SCALE, ms=row["ms"], plain_ms=row["plain_ms"],
         wrapper_ms=sum(e["wrapper_ms"] for e in per_shape),
         library_ms=library_ms, library="cudnn conv_transpose2d + batch_norm + relu (3 calls)",
         bound_ms=row["bound_ms"], bound_by=row["bound_by"], share_of_bound=row["bound_ms"] / row["ms"],
         ptxas=_ptxas("deconv.cu"))
    return row


def phase_k4(dev, flush):
    """K4 against its plain version at the head's three bench-width shapes
    (bf16 activations, timed) and at the extra shapes (bf16 and float32);
    `ms`, `wrapper_ms` and `unpacked_wrapper_ms` as in phase_k3 (`ms`
    includes the quantize pre-pass).  PyTorch has no int8 transposed
    convolution: no library yardstick."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import deconv

    per_shape, extra = [], []
    for idx, shape in enumerate(HEAD_SHAPES + EXTRA_HEAD_SHAPES):
        x, weight, scale, bias, _ = _head_inputs(shape, torch.bfloat16, dev, 20 + idx)
        wq, ws = deconv.quantize_deconv_weight(weight)
        sx = torch.amax(torch.abs(x.float())) / 127.0
        got = deconv.fused_deconv_bn_relu_int8(x, wq, ws, scale, bias, sx)
        ref = deconv.fused_deconv_bn_relu_int8_plain(x, wq, ws, scale, bias, sx)
        torch.cuda.synchronize()
        err, sc, ok = _head_err(got, ref, HEAD_RTOL, HEAD_ATOL_OF_SCALE)
        check(ok, "K4 differs from plain at %s: %g (scale %g)" % (shape, err, sc))
        mismatches = int(torch.sum(got != ref))
        if idx >= len(HEAD_SHAPES):
            x32 = x.float()
            e32, sc32, ok32 = _head_err(
                deconv.fused_deconv_bn_relu_int8(x32, wq, ws, scale, bias, sx),
                deconv.fused_deconv_bn_relu_int8_plain(x32, wq, ws, scale, bias, sx),
                HEAD_F32_RTOL, HEAD_F32_RTOL)
            check(ok32, "K4 float32 differs from plain at %s: %g (scale %g)" % (shape, e32, sc32))
            extra.append(dict(shape=list(shape), bf16_err=err, bf16_mismatches=mismatches,
                              f32_err=e32, scale=sc))
            continue
        ops = deconv.pack_k4(wq, ws, scale, bias)
        b_bytes, b_ops = _head_bound(shape, 2, 1, INT8_OPS_PER_S)
        entry = dict(
            shape=list(shape), max_abs_err=err, mismatches=mismatches, scale=sc,
            ms=cuda_ms(lambda: deconv.launch(x, ops, sx), 20, flush),
            wrapper_ms=cuda_ms(lambda: deconv.fused_deconv_bn_relu_int8_packed(x, ops, sx), 20, flush),
            unpacked_wrapper_ms=cuda_ms(
                lambda: deconv.fused_deconv_bn_relu_int8(x, wq, ws, scale, bias, sx), 20, flush),
            plain_ms=cuda_ms(
                lambda: deconv.fused_deconv_bn_relu_int8_plain(x, wq, ws, scale, bias, sx), 5, flush),
            bound_bytes_ms=b_bytes, bound_ops_ms=b_ops)
        entry["share_of_bound"] = _share(entry)
        per_shape.append(entry)
    row = _head_row("fused_deconv_bn_relu_int8", "multi_view_active_learning_tpu_torch/csrc/deconv.cu",
                    "multi_view_active_learning_tpu/ops/pallas/deconv.py:280", per_shape, None)
    emit("k4", per_shape=per_shape, extra=extra, rtol=HEAD_RTOL, atol_of_scale=HEAD_ATOL_OF_SCALE,
         ms=row["ms"], plain_ms=row["plain_ms"], wrapper_ms=sum(e["wrapper_ms"] for e in per_shape),
         bound_ms=row["bound_ms"], bound_by=row["bound_by"], share_of_bound=row["bound_ms"] / row["ms"])
    return row


def phase_int8_conv(dev):
    """The int8 backbone's s8 im2col products (torch._int_mm) on the card
    against the CPU's: the stem and two 3x3 convs of PoseResNet-50 on 4
    crops; the s32 accumulators must be bit-equal."""
    import torch
    from multi_view_active_learning_tpu_torch.models import quantize

    gen = torch.Generator().manual_seed(5)
    convs = {  # name: (input NHWC, Conv2d weight, stride)
        "stem": ((4, IMG, IMG, 3), (64, 3, 7, 7), 2),
        "layer1_0/conv2": ((4, IMG // 4, IMG // 4, 64), (64, 64, 3, 3), 1),
        "layer2_0/conv2": ((4, IMG // 4, IMG // 4, 128), (128, 128, 3, 3), 2),
    }
    shapes = {}
    for name, (xshape, wshape, stride) in convs.items():
        x = torch.randn(xshape, generator=gen).to(torch.bfloat16)
        wq, _ = quantize._quant_weight(torch.randn(wshape, generator=gen))
        wq = wq.permute(0, 2, 3, 1).contiguous()
        xq = quantize._quant_act(x, torch.amax(torch.abs(x.float())) / 127.0)
        cpu = quantize._int8_conv(xq, wq, stride)
        card = quantize._int8_conv(xq.to(dev), wq.to(dev), stride)
        torch.cuda.synchronize()
        check(torch.equal(card.cpu(), cpu), "int8 conv %s: card and CPU s32 sums differ" % name)
        shapes[name] = list(cpu.shape)
    emit("int8_conv", bit_equal=True, s32_shapes=shapes)


def phase_model(dev):
    """PoseResNet-50 at 128x128 on the golden weights, TF32 off."""
    import torch
    from multi_view_active_learning_tpu_torch.models import PoseResNet

    g = np.load(GOLDENS)
    names = json.loads(bytes(g["pose_resnet50_names"]).decode())
    shapes = json.loads(bytes(g["pose_resnet50_shapes"]).decode())
    values = golden_fill_values(names, shapes, int(g["weight_seed"]))
    model = PoseResNet(int(g["num_joints"]), 50).to(dev).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in values.items()}, strict=True)
    hw, batch = int(g["input_hw"]), int(g["batch"])
    x = np.random.default_rng(int(g["input_seed"])).normal(size=(batch, 3, hw, hw))
    with torch.inference_mode():
        y = model(torch.from_numpy(x.astype(np.float32)).to(dev)).cpu().numpy()
    ref = g["pose_resnet50_output"]
    scale = float(np.abs(ref).max())
    max_err = float(np.abs(y - ref).max())
    cos = float(np.dot(y.ravel(), ref.ravel()) / (np.linalg.norm(y) * np.linalg.norm(ref)))
    check(max_err <= 1e-4 * scale and cos > 0.999999,
          "PoseResNet-50 off the goldens: max_err %g scale %g cos %r" % (max_err, scale, cos))
    emit("model", max_err=max_err, scale=scale, cosine=cos, tolerance=1e-4 * scale,
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])


def phase_hrnet_model(dev):
    """HRNet-W32 at 128x128 on the golden weights, TF32 off."""
    import torch
    from multi_view_active_learning_tpu_torch.models import PoseHighResolutionNet

    g = np.load(GOLDENS)
    names = json.loads(bytes(g["hrnet_w32_names"]).decode())
    shapes = json.loads(bytes(g["hrnet_w32_shapes"]).decode())
    values = golden_fill_values(names, shapes, int(g["weight_seed"]))
    model = PoseHighResolutionNet(int(g["num_joints"])).to(dev).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in values.items()}, strict=True)
    hw, batch = int(g["input_hw"]), int(g["batch"])
    x = np.random.default_rng(int(g["input_seed"])).normal(size=(batch, 3, hw, hw))
    with torch.inference_mode():
        y = model(torch.from_numpy(x.astype(np.float32)).to(dev)).cpu().numpy()
    ref = g["hrnet_w32_output"]
    scale = float(np.abs(ref).max())
    max_err = float(np.abs(y - ref).max())
    cos = float(np.dot(y.ravel(), ref.ravel()) / (np.linalg.norm(y) * np.linalg.norm(ref)))
    check(max_err <= 1e-4 * scale and cos > 0.999999,
          "HRNet-W32 off the goldens: max_err %g scale %g cos %r" % (max_err, scale, cos))
    emit("hrnet_model", max_err=max_err, scale=scale, cosine=cos, tolerance=1e-4 * scale,
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])


def phase_triangulation(dev, pairs):
    """Gaussians rendered at projected ground truth on 31 views, decoded by
    K1 and triangulated: ground truth must come back."""
    import torch
    from multi_view_active_learning_tpu_torch.ops import heatmap, triangulate
    from multi_view_active_learning_tpu_torch.ops.geometry import project_points_np

    rng = np.random.default_rng(3)
    proj = make_ring_cameras(VIEWS, img=IMG)
    gt = rng.normal(scale=30.0, size=(BATCH, JOINTS, 3))
    kp2d = np.stack([
        np.stack([project_points_np(proj[v].astype(np.float64), gt[b]) for v in range(VIEWS)])
        for b in range(BATCH)
    ])  # [B, V, K, 2]
    h = IMG // 4
    check(bool((kp2d >= 0).all() and (kp2d < IMG).all()), "ground truth leaves the crops")
    hm = heatmap.render_gaussian_heatmaps(
        torch.from_numpy((kp2d / 4.0).astype(np.float32)).to(dev), h, h, 2.0
    )  # [B, V, K, h, w]
    res = triangulate.triangulate_frames(
        hm.contiguous(),
        torch.from_numpy(np.broadcast_to(proj, (BATCH, VIEWS, 3, 4)).copy()).to(dev),
        torch.ones((BATCH, JOINTS), dtype=torch.bool, device=dev),
        torch.from_numpy(pairs).to(dev),
        stride=4,
    )
    err = np.linalg.norm(res["keypoints_3d"].cpu().numpy() - gt, axis=-1)
    inliers = res["inlier_count"].cpu().numpy()
    check(float(err.mean()) < GT_MEAN_TOL and float(err.max()) < GT_MAX_TOL,
          "ground truth not recovered: mean %g max %g" % (err.mean(), err.max()))
    check(bool((inliers == VIEWS).all()), "views rejected on clean data: %s" % inliers)
    emit("triangulation", frames=BATCH, views=VIEWS, joints=JOINTS, pairs=len(pairs),
         mean_err=float(err.mean()), max_err=float(err.max()),
         tolerance=[GT_MEAN_TOL, GT_MAX_TOL], inlier_count=inliers.tolist())


def _engine(dtype, dev, state_dict, model="POSE_RESNET", al=None, **tpu):
    """A PoseResNet-50 (or, with model="HRNET", HRNet-W32) engine on the
    given weights; `al` sets AL options and `tpu` TPU options (the float
    paths turn the default int8 scoring off)."""
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.engine import Engine

    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = JOINTS
    cfg.POSE_ESTIMATOR.TYPE = model
    cfg.POSE_ESTIMATOR.NUM_LAYERS = DEPTH
    cfg.TPU.INT8_SCORING = False
    cfg.TPU.COMPUTE_DTYPE = dtype
    for key, value in tpu.items():
        setattr(cfg.TPU, key, value)
    for key, value in (al or {}).items():
        setattr(cfg.AL, key, value)
    engine = Engine(cfg, device=dev)
    engine.load_state_dict(state_dict)
    return engine


def _timed_steps(fn, warmup, steps):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, out


def _check_scores(out, tag):
    import torch

    shapes = {k: tuple(v.shape) for k, v in out.items()}
    check(shapes == {"keypoints_3d": (BATCH, JOINTS, 3), "sal_metric": (BATCH,),
                     "inlier_count": (BATCH,), "al_metric": (BATCH,), "mkpe": (BATCH,)},
          "%s shapes %s" % (tag, shapes))
    for k, v in out.items():
        check(bool(torch.all(torch.isfinite(v))), "%s %s not finite" % (tag, k))
    inl = out["inlier_count"]
    check(bool(torch.all((inl >= 2) & (inl <= VIEWS))), "%s inlier counts %s" % (tag, inl))


def phase_main_path(dev):
    """The float scoring pass at bench.py width, with the launch counters
    read around it.  Returns the counts and what the int8 and K3 paths
    reuse: the weights, the inputs and the bf16 engine's heatmaps."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.models import PoseResNet
    from multi_view_active_learning_tpu_torch.ops import coreset, triangulate

    state_dict = random_state_dict(PoseResNet(JOINTS, DEPTH), seed=7)
    engines = {d: _engine(d, dev, state_dict) for d in ("bfloat16", "float32")}
    pairs = engines["float32"].pairs(VIEWS)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(
        rng.integers(0, 256, size=(BATCH, VIEWS, IMG, IMG, 3)).astype(np.uint8)
    ).to(dev)
    proj = torch.from_numpy(
        np.broadcast_to(make_ring_cameras(VIEWS, img=IMG), (BATCH, VIEWS, 3, 4)).copy()
    ).to(dev)
    valid = torch.ones((BATCH, JOINTS), dtype=torch.bool, device=dev)
    gt = torch.from_numpy(rng.normal(scale=30.0, size=(BATCH, JOINTS, 3)).astype(np.float32)).to(dev)
    pairs_t = torch.from_numpy(pairs).to(dev)
    feats = torch.from_numpy(rng.normal(size=(POOL, POOL_DIM)).astype(np.float32)).to(dev)
    labeled = torch.from_numpy(np.arange(POOL) >= POOL - LABELED).to(dev)

    kernels.reset_launch_counts()
    steps, heats = {}, {}
    for dtype, engine in engines.items():
        step_ms, out = _timed_steps(
            lambda: engine.score_step(images, proj, valid, pairs_t, gt), 2, 10
        )
        _check_scores(out, dtype)
        # Split of the step: the forward alone, then the decode and
        # triangulation alone on its heatmaps.
        forward_ms, heat = _timed_steps(lambda: engine.forward(images), 1, 5)
        with torch.inference_mode():
            tri_ms, _ = _timed_steps(
                lambda: triangulate.triangulate_frames(heat, proj, valid, pairs_t, stride=4), 1, 5
            )
        steps[dtype] = dict(step_ms=step_ms, frames_per_s=BATCH / step_ms * 1e3,
                            forward_ms=forward_ms, triangulate_ms=tri_ms,
                            inlier_count=out["inlier_count"].tolist())
        heats[dtype] = heat
    eval_out = engines["float32"].eval_step(images, proj, valid, pairs_t)
    coreset_ms, sel = _timed_steps(lambda: coreset.k_center_greedy(feats, labeled, PICK), 1, 3)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()

    check(tuple(eval_out["keypoints_3d"].shape) == (BATCH, JOINTS, 3)
          and bool(torch.all(torch.isfinite(eval_out["keypoints_3d"]))), "eval_step output")
    sel = sel.cpu().numpy()
    plain_sel = coreset.k_center_greedy(feats.cpu(), labeled.cpu(), PICK).numpy()
    check(np.array_equal(sel, plain_sel), "coreset selection differs from the plain version's")
    check(bool((sel < POOL - LABELED).all()) and len(set(sel.tolist())) == PICK, "coreset picks")
    for name in ("fused_decode", "min_distance_to_centers"):
        check(launches[name] > 0, "kernel %s was not launched on the main path" % name)
    for name in ("fused_deconv_bn_relu", "fused_deconv_bn_relu_int8"):
        check(launches[name] == 0, "kernel %s launched on the standard-head path" % name)
    emit("main_path", batch=BATCH, views=VIEWS, img=IMG, joints=JOINTS, depth=DEPTH,
         pairs=len(pairs), steps=steps, coreset_ms=coreset_ms, pool=POOL, pick=PICK,
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
         launches=launches)
    small = torch.from_numpy(rng.integers(
        0, 256, size=(BATCH, VIEWS, INT8_BAR_IMG, INT8_BAR_IMG, 3)).astype(np.uint8)).to(dev)
    ctx = dict(state_dict=state_dict, images=images, proj=proj, valid=valid, gt=gt,
               pairs=pairs_t, heats=heats, small=small,
               small_heat=engines["bfloat16"].forward(small))
    return launches, ctx


def _agreement(heat, ref):
    """Cosine, max error over scale, and per-map argmax agreement of two
    [B, V, K, h, w] heatmap sets."""
    import torch

    a, b = heat.float().reshape(-1), ref.float().reshape(-1)
    cos = float(torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)))
    scale = float(torch.max(torch.abs(b)))
    maps = heat.shape[-2] * heat.shape[-1]
    agree = float(torch.mean((heat.reshape(-1, maps).argmax(-1)
                              == ref.reshape(-1, maps).argmax(-1)).float()))
    return cos, float(torch.max(torch.abs(a - b))) / scale, agree


# The paths through the head kernels, each a bf16 engine on the main path's
# weights: TPU options, and the kernel it must launch 3 times per forward.
PATHS = {
    "int8": (dict(INT8_SCORING=True), None),  # the default configuration
    "int8_k4": (dict(INT8_SCORING=True, INT8_DECONV=True), "fused_deconv_bn_relu_int8"),
    "bf16_k3": (dict(PALLAS_HEAD=True), "fused_deconv_bn_relu"),
}


def phase_paths(dev, ctx):
    """Each of PATHS at bench width: calibrated with int8_calibrate on its
    batch (the int8 paths), then timed score_steps and forwards, with the
    launch counters set to 0 before and read after.  Against the float bf16
    engine's heatmaps on the same frames: the int8 paths at bench width
    (cosine) and on 64x64 crops with dynamic scales (the JAX package's
    int8 bar), the K3 path to the bf16 bar."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels

    images = ctx["images"]
    args = (images, ctx["proj"], ctx["valid"], ctx["pairs"], ctx["gt"])
    float_floor = _agreement(ctx["heats"]["bfloat16"], ctx["heats"]["float32"])[2]
    counts = {}
    for name, (tpu, kernel) in PATHS.items():
        engine = _engine("bfloat16", dev, ctx["state_dict"], **tpu)
        check(engine.use_int8 == ("INT8_SCORING" in tpu), "%s: int8 gate" % name)
        kernels.reset_launch_counts()
        scales = engine.int8_calibrate(images)
        forwards = int(scales is not None)
        step_ms, out = _timed_steps(lambda: engine.score_step(*args, int8_scales=scales), 1, 5)
        forward_ms, heat = _timed_steps(lambda: engine.forward(images, scales), 1, 3)
        small_heat = engine.forward(ctx["small"])
        torch.cuda.synchronize()
        forwards += 6 + 4 + 1
        launches = kernels.launch_counts()
        _check_scores(out, name)
        check(launches["fused_decode"] == 6, "%s: K1 launches %s" % (name, launches))
        for head in ("fused_deconv_bn_relu", "fused_deconv_bn_relu_int8"):
            want = 3 * forwards if head == kernel else 0
            check(launches[head] == want, "%s: %s launched %d times, want %d"
                  % (name, head, launches[head], want))
        cos, max_err, agree = _agreement(heat, ctx["heats"]["bfloat16"])
        small = _agreement(small_heat, ctx["small_heat"])
        if scales is not None:
            check(cos > INT8_COS, "%s off the float heatmaps: cosine %g" % (name, cos))
            check(small[0] > INT8_COS and small[2] > INT8_ARGMAX_AGREE,
                  "%s off the float heatmaps at %dx%d: cosine %g, argmax agreement %g"
                  % (name, INT8_BAR_IMG, INT8_BAR_IMG, small[0], small[2]))
        else:
            for c, e in ((cos, max_err), small[:2]):
                check(c > K3_PATH_COS and e <= K3_PATH_MAX_ERR,
                      "%s off the standard head: cosine %g, max error %g of scale" % (name, c, e))
        emit("path_" + name, options=tpu, batch=BATCH, views=VIEWS, img=IMG, depth=DEPTH,
             step_ms=step_ms, frames_per_s=BATCH / step_ms * 1e3, forward_ms=forward_ms,
             scales=None if scales is None else len(scales), forwards=forwards,
             cosine=cos, max_err_of_scale=max_err, argmax_agreement=agree,
             float_bf16_f32_argmax_agreement=float_floor,
             at_64=dict(cosine=small[0], max_err_of_scale=small[1], argmax_agreement=small[2]),
             launches=launches)
        counts[name] = launches
        del engine
    return counts


# The HRNet-W32 path's score_steps: (label, strategy, score_step keywords,
# AL options of the engine).
HRNET_STEPS = [
    ("TRIANGULATION", "TRIANGULATION", {}, None),
    ("MPE", "MPE", {}, None),
    ("HP", "HP", {}, None),
    ("BSB", "BSB", {}, None),
    ("BSB_STD", "BSB", dict(bsb_aggregate="STD"), None),
    ("DIRECT_OPTIMIZATION", "TRIANGULATION", {}, dict(DIRECT_OPTIMIZATION=True)),
]
STEP_WARMUP, STEP_RUNS = 1, 3
# Uncertainty metrics on the card against the same computation on the CPU
# on the same heatmaps: the peak masks are compared for equality; the
# metrics within rtol 1e-4 and atol 1e-5 (float32 exp, log and sums in
# another order).
UNC_RTOL, UNC_ATOL = 1e-4, 1e-5
# embed_step against score_step's embedding on the same frames: the same
# function, so equal unless cuDNN picks another algorithm between calls;
# held to 1e-3 of the embedding's scale (a bf16 step is 2^-8 relative).
EMBED_ATOL_OF_SCALE = 1e-3


def hrnet_state_dict():
    """Seeded HRNet-W32 weights for the bench-width paths.  The fill keeps
    activations O(1) through each BN, but the exchange units' sums grow the
    high-resolution branch so that the final conv's output has a std of
    about 8,400 (measured at 128x128 on the CPU): every row-softmax
    saturates (HP = 0, one peak a map).  The final layer's weight is scaled
    by 1e-4, so the uncertainty metrics see heatmaps of about unit scale."""
    import torch
    from multi_view_active_learning_tpu_torch.models import PoseHighResolutionNet

    state_dict = random_state_dict(PoseHighResolutionNet(JOINTS), seed=8)
    state_dict["final_layer.weight"] = state_dict["final_layer.weight"] * torch.tensor(1e-4)
    return state_dict


def phase_hrnet_path(dev, ctx):
    """HRNet-W32 in bf16 at bench width through Engine.score_step: each of
    HRNET_STEPS timed, with the launch counters set to 0 before and read
    after (K1 once per step; K2, K3 and K4 never); MPE's peak masks and the
    three metrics (AVG and STD) on the card against the CPU on the same
    heatmaps; then the TPU.INT8_SCORING_HRNET path, calibrated on the batch,
    against the float heatmaps: cosine at bench width (printed) and, with
    dynamic scales on 64x64 crops, the JAX package's bar (cosine > 0.99)."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.ops import uncertainty

    state_dict = hrnet_state_dict()
    images, valid = ctx["images"], ctx["valid"]
    args = (images, ctx["proj"], valid, ctx["pairs"], ctx["gt"])
    engines, steps, counts = {}, {}, {}
    for label, strategy, kw, al in HRNET_STEPS:
        key = json.dumps(al)
        if key not in engines:
            engines[key] = _engine("bfloat16", dev, state_dict, model="HRNET", al=al)
        engine = engines[key]
        check(not engine.use_int8, "HRNet float path: int8 gate")
        kernels.reset_launch_counts()
        step_ms, out = _timed_steps(
            lambda: engine.score_step(*args, al_strategy=strategy, **kw), STEP_WARMUP, STEP_RUNS)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        _check_scores(out, "hrnet " + label)
        want = dict.fromkeys(launches, 0)
        want["fused_decode"] = STEP_WARMUP + STEP_RUNS
        check(launches == want, "hrnet %s launches %s, want %s" % (label, launches, want))
        if strategy != "TRIANGULATION":
            check(bool(torch.all(out["al_metric"] > 0)), "hrnet %s metric %s" % (label, out["al_metric"]))
        forward_ms, _ = _timed_steps(lambda: engine.forward(images), 1, 3)
        steps[label] = dict(step_ms=step_ms, frames_per_s=BATCH / step_ms * 1e3, forward_ms=forward_ms,
                            al_metric=out["al_metric"].tolist(), sal_metric=out["sal_metric"].tolist(),
                            inlier_count=out["inlier_count"].tolist())
        counts[label] = launches

    # The metrics on the card against the CPU on the same heatmaps.
    heat = engines["null"].forward(images)
    with torch.inference_mode():
        mask = uncertainty.local_peak_mask(heat)
        torch.cuda.synchronize()
        cpu_heat, cpu_valid = heat.cpu(), valid.cpu()
        check(torch.equal(mask.cpu(), uncertainty.local_peak_mask(cpu_heat)),
              "MPE peak masks differ between the card and the CPU")
        metric_errs = {}
        for name, fn in (("MPE", uncertainty.multi_peak_entropy),
                         ("HP", uncertainty.highest_probability),
                         ("BSB", uncertainty.best_vs_second_best)):
            for agg in ("AVG", "STD"):
                card, cpu = fn(heat, valid, agg).cpu(), fn(cpu_heat, cpu_valid, agg)
                check(bool(torch.allclose(card, cpu, rtol=UNC_RTOL, atol=UNC_ATOL)),
                      "%s %s differs between the card and the CPU: %s %s" % (name, agg, card, cpu))
                metric_errs["%s_%s" % (name, agg)] = float(torch.max(torch.abs(card - cpu)))

    # TPU.INT8_SCORING_HRNET.
    int8 = _engine("bfloat16", dev, state_dict, model="HRNET", INT8_SCORING=True,
                   INT8_SCORING_HRNET=True)
    check(int8.use_int8, "HRNet int8 gate")
    kernels.reset_launch_counts()
    scales = int8.int8_calibrate(images)
    int8_ms, out = _timed_steps(lambda: int8.score_step(*args, int8_scales=scales), 1, 3)
    int8_fwd_ms, int8_heat = _timed_steps(lambda: int8.forward(images, scales), 1, 3)
    torch.cuda.synchronize()
    int8_launches = kernels.launch_counts()
    _check_scores(out, "hrnet int8")
    check(int8_launches["fused_decode"] == 4, "hrnet int8: K1 launches %s" % int8_launches)
    cos, max_err, agree = _agreement(int8_heat, heat)
    small = _agreement(int8.forward(ctx["small"]), engines["null"].forward(ctx["small"]))
    check(small[0] > INT8_COS, "HRNet int8 off the float heatmaps at %dx%d: cosine %g"
          % (INT8_BAR_IMG, INT8_BAR_IMG, small[0]))
    emit("hrnet_path", model="HRNet-W32", dtype="bfloat16", batch=BATCH, views=VIEWS, img=IMG,
         joints=JOINTS, steps=steps, launches=counts, peak_masks_equal=True,
         peaks_per_map=float(mask.sum()) / mask[..., 0, 0].numel(), metric_card_cpu_err=metric_errs,
         int8=dict(step_ms=int8_ms, frames_per_s=BATCH / int8_ms * 1e3, forward_ms=int8_fwd_ms,
                   scales=len(scales), cosine=cos, max_err_of_scale=max_err, argmax_agreement=agree,
                   at_64=dict(cosine=small[0], max_err_of_scale=small[1], argmax_agreement=small[2]),
                   launches=int8_launches))


def phase_embedding(dev, ctx):
    """PoseResNet-50, CORESET with AL.CORESET_FEATURES=EMBEDDING at bench
    width: score_step returns the [4, 2048] embedding, embed_step agrees
    with it, and CoreSet(features=...) on a [2048, 2048] pool on the card
    (the scored frames' embeddings in its first rows, 200 labeled rows)
    picks the plain CPU run's indices, through K2 at d = 2048."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.ops import coreset

    engine = _engine("bfloat16", dev, ctx["state_dict"],
                     al=dict(STRATEGY="CORESET", CORESET_FEATURES="EMBEDDING"))
    check(not engine.use_int8, "EMBEDDING: int8 gate")
    images = ctx["images"]
    args = (images, ctx["proj"], ctx["valid"], ctx["pairs"], ctx["gt"])
    kernels.reset_launch_counts()
    step_ms, out = _timed_steps(lambda: engine.score_step(*args, al_strategy="CORESET"),
                                STEP_WARMUP, STEP_RUNS)
    forward_ms, embedded = _timed_steps(lambda: engine.embed_step(images), 1, 3)
    torch.cuda.synchronize()
    step_launches = kernels.launch_counts()
    emb = out.pop("embedding")
    _check_scores(out, "embedding")
    check(tuple(emb.shape) == (BATCH, EMBED_DIM) and bool(torch.all(torch.isfinite(emb))),
          "embedding %s" % (tuple(emb.shape),))
    check(step_launches["fused_decode"] == STEP_WARMUP + STEP_RUNS,
          "EMBEDDING: K1 launches %s" % step_launches)
    scale = float(torch.max(torch.abs(emb)))
    embed_err = float(torch.max(torch.abs(embedded - emb)))
    check(embed_err <= EMBED_ATOL_OF_SCALE * scale,
          "embed_step off score_step's embedding: %g of %g" % (embed_err, scale))

    gen = torch.Generator(device=dev).manual_seed(9)
    feats = torch.randn((POOL, EMBED_DIM), generator=gen, device=dev)
    feats[:BATCH] = emb
    sal = {"s%04d" % i: np.zeros((JOINTS, 3)) for i in range(POOL - LABELED)}
    al = {"a%04d" % i: np.zeros((JOINTS, 3)) for i in range(LABELED)}
    kernels.reset_launch_counts()
    coreset_ms, picks = _timed_steps(
        lambda: coreset.CoreSet(sal, al, 0, features=feats).select_batch(PICK), 1, 3)
    torch.cuda.synchronize()
    pick_launches = kernels.launch_counts()
    check(pick_launches["min_distance_to_centers"] == 4,
          "EMBEDDING coreset: K2 launches %s" % pick_launches)
    plain = coreset.CoreSet(sal, al, 0, device="cpu", features=feats.cpu()).select_batch(PICK)
    check(picks == plain, "EMBEDDING coreset picks differ from the plain CPU run's")
    emit("embedding_path", model="PoseResNet-50", dtype="bfloat16", batch=BATCH, views=VIEWS,
         img=IMG, embedding=list(emb.shape), step_ms=step_ms, frames_per_s=BATCH / step_ms * 1e3,
         forward_ms=forward_ms, embed_step_err=embed_err, embedding_scale=scale,
         pool=[POOL, EMBED_DIM], labeled=LABELED, pick=PICK, coreset_ms=coreset_ms,
         picks_equal_plain=True, first_picks=picks[:5], launches=step_launches,
         coreset_launches=pick_launches)


# The pool sweep (bench.py's pool mode, bench.py:57-60): a synthetic pool
# of 64 frames x 31 cameras, PoseResNet-50, B=4, two decode workers, the
# native decoder.
SWEEP_FRAMES, SWEEP_WORKERS = 64, 2
SAL_GOLDENS = os.path.join(REPO, "tests", "fixtures", "sal_dict_goldens.json")
# Frames selected and pseudo-labeled a step: on the golden tree, and at
# full width.
GOLDEN_AL, GOLDEN_SAL, SWEEP_AL, SWEEP_SAL = 2, 2, 8, 8
# sal_dict against sal_dict (tests/test_sal_parity.py:185-210): inlier
# counts exact, metrics rel / abs 1e-3, keypoints rtol 1e-2 / atol 5e-2.
SAL_TOL, KP_RTOL, KP_ATOL = 1e-3, 1e-2, 5e-2


def _sweep_cfg(root, joints, log_dir, **options):
    """The sweep's configuration: the default one on a synthetic tree, with
    PoseResNet-50, TRIANGULATION and `options` given as {"NODE__KEY": value}."""
    from multi_view_active_learning_tpu_torch.config import get_default_configs

    cfg = get_default_configs()
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = root
    cfg.DATA.NUM_JOINTS = joints
    cfg.POSE_ESTIMATOR.NUM_LAYERS = DEPTH
    cfg.AL.STRATEGY = "TRIANGULATION"  # bench.py's default (the config's is RANDOM)
    cfg.LOG_DIR = log_dir
    for dotted, value in options.items():
        node = cfg
        *path, leaf = dotted.split("__")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    return cfg


def _sal_dict_err(got, ref, tag):
    """The largest difference of sal_dict `got` from `ref` over its
    tolerance (at most 1 passes); the guids and inlier counts must be
    equal."""
    check(set(got["al_metric"]) == set(ref["al_metric"]), "%s: guids differ" % tag)
    worst = 0.0
    for guid in ref["al_metric"]:
        check(got["inlier_count"][guid] == ref["inlier_count"][guid],
              "%s: inlier counts differ at %s" % (tag, guid))
        for metric in ("al_metric", "sal_metric", "mkpe"):
            a, b = got[metric][guid], ref[metric][guid]
            worst = max(worst, abs(a - b) / (SAL_TOL + SAL_TOL * abs(b)))
        a = np.asarray(got["pred_3d_keypoints"][guid])
        b = np.asarray(ref["pred_3d_keypoints"][guid])
        worst = max(worst, float(np.max(np.abs(a - b) / (KP_ATOL + KP_RTOL * np.abs(b)))))
    check(worst <= 1.0, "%s: sal_dict off by %g of its tolerance" % (tag, worst))
    return worst


def _logs(cfg):
    d = os.path.join(cfg.LOG_DIR, cfg.EXPR_NAME)
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _first_jpeg_checksum(tree):
    import hashlib

    first = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs
                   if f.endswith(".jpg"))[0]
    with open(first, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class _CoreSetSpy:
    """Stands in for the strategy module's `coreset_ops` while a step runs:
    builds the real CoreSet and keeps it, so the features K2 ranked can be
    read back."""

    def __init__(self, ops):
        self.ops, self.built = ops, []

    def CoreSet(self, *args, **kwargs):
        self.built.append(self.ops.CoreSet(*args, **kwargs))
        return self.built[-1]


def _coreset_step(strategy, pool, al_frames, state):
    """sample_next_batch at iteration 1 (after a random iteration 0) with
    the launch counters set to 0 just before it: (launches, seconds, the
    CoreSet it ranked with)."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch import strategy as strategy_mod

    strategy.sample_next_batch(pool, al_frames, 0, state, 0)
    spy = _CoreSetSpy(strategy_mod.coreset_ops)
    strategy_mod.coreset_ops = spy
    try:
        if strategy.device.type == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        strategy.sample_next_batch(pool, al_frames, 0, state, 1)
        if strategy.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        strategy_mod.coreset_ops = spy.ops
    check(len(spy.built) == 1, "CORESET step built %d CoreSets" % len(spy.built))
    return launches, seconds, spy.built[0]


def _coreset_k2(cs, dev, tag, float64_ref=False):
    """K2 against its plain version on the card, on the features and
    labeled mask a CORESET step gave it (CoreSet.select_batch's mask: the
    rows after the candidates are centers)."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import pairwise

    feats = torch.as_tensor(cs.features, dtype=torch.float32).to(dev).contiguous()
    mask = torch.zeros((cs.n_obs,), dtype=torch.bool, device=dev)
    mask[cs.n_sal:] = True
    _, err = _k2_check(pairwise, feats, mask, tag, float64_ref=float64_ref)
    return dict(shape=list(feats.shape), centers=cs.n_obs - cs.n_sal, max_abs_err=err)


def _greedy_gaps(features, n_sal, picks):
    """k-center greedy in float64 (labeled rows after the first `n_sal`):
    at each of `picks` steps, the winner's distance to its nearest center
    less the runner-up's."""
    x = np.asarray(features, np.float64)
    dist = np.linalg.norm(x[:n_sal, None] - x[None, n_sal:], axis=-1).min(axis=1)
    gaps = []
    for _ in range(picks):
        order = np.argsort(-dist, kind="stable")
        gaps.append(float(dist[order[0]] - dist[order[1]]))
        dist = np.minimum(dist, np.linalg.norm(x[:n_sal] - x[order[0]], axis=-1))
    return gaps


def _golden_sweeps(dev, tmp):
    """The golden tree (8 frames x 4 cameras) with the golden PoseResNet-50
    weights, float32 (TF32 off), SVD, the PIL decoder, B=2: the sweep, the
    AL step (TRIANGULATION under SAL) and CORESET steps under AL on POSE and
    on EMBEDDING features, on the card and on the CPU.  The card's sal_dict
    equals the CPU's, and the goldens' when the tree is the goldens' tree;
    the guid logs are the CPU's (the golden tree's metrics lie at least 0.14
    apart, far beyond the tolerance) and each step's SAL-DICT-ITER-1 is the
    CPU's within the tolerance.  In each CORESET step K2 launches once and
    is held to its plain version on the step's own features and mask, and
    every greedy pick wins by more than four times the largest difference
    between the card's features and the CPU's, so equal picks are not luck."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.data import build_dataset
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy

    with open(SAL_GOLDENS) as f:
        golden = json.load(f)
    meta = golden["meta"]
    joints = meta["num_joints"]
    tree = generate_panoptic_tree(os.path.join(tmp, "golden_tree"),
                                  num_train_frames=meta["num_frames"], num_val_frames=2,
                                  num_joints=joints, num_cameras=meta["num_cams"])
    matched = _first_jpeg_checksum(tree) == meta["tree_checksum"]
    w = golden["models"]["pose_resnet50"]["weights"]
    state = {k: torch.from_numpy(v) for k, v in golden_fill_values(
        w["names"], w["shapes"], int(meta["weight_seed"])).items()}
    base = dict(POSE_ESTIMATOR__NUM_LAYERS=50, DATA__USE_NATIVE_LOADER=False,
                TPU__COMPUTE_DTYPE="float32",
                TPU__INT8_SCORING=False, TPU__DLT_METHOD="svd", AL__INFERENCE__BATCH_SIZE=2,
                AL__INFERENCE__NUM_WORKERS=0, EXPR_TYPE="SAL", SAL__INLIER_THRESHOLD=1)
    runs = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        cfg = _sweep_cfg(tree, joints, os.path.join(tmp, where, "triangulation"), **base)
        strategy = ActiveLearningStrategy(cfg, device=device)
        pool = build_dataset(cfg, "train")
        pool.resample_unlabeled_data()
        kernels.reset_launch_counts()
        sal = strategy._compute_sal_dict(pool, state)
        sweep_launches = kernels.launch_counts()
        pool = build_dataset(cfg, "train")
        for iteration in (0, 1):
            strategy.sample_next_batch(pool, GOLDEN_AL, GOLDEN_SAL, state, iteration)
        runs[where] = dict(sal=sal, logs=_logs(cfg), sweep_launches=sweep_launches)
        # CORESET steps under AL, on the triangulated poses and on the
        # pooled trunk embeddings (`_embed_labeled` and the features'
        # assembly included).
        for features in ("POSE", "EMBEDDING"):
            ccfg = _sweep_cfg(tree, joints, os.path.join(tmp, where, "coreset_" + features),
                              **dict(base, EXPR_TYPE="AL", AL__STRATEGY="CORESET",
                                     AL__CORESET_FEATURES=features))
            launches, _, cs = _coreset_step(ActiveLearningStrategy(ccfg, device=device),
                                            build_dataset(ccfg, "train"), GOLDEN_AL, state)
            runs[where][features] = dict(logs=_logs(ccfg), launches=launches, coreset=cs)
    card, cpu = runs["card"], runs["cpu"]
    batches = -(-meta["num_frames"] // 2)
    check(card["sweep_launches"]["fused_decode"] == batches,
          "golden sweep: K1 launched %s times for %d batches" % (card["sweep_launches"], batches))
    card_cpu = _sal_dict_err(card["sal"], cpu["sal"], "golden sweep, card against CPU")
    against_golden = None
    if matched:
        gold = golden["models"]["pose_resnet50"]["sal_dicts"]["TRIANGULATION"]
        against_golden = _sal_dict_err(card["sal"], gold, "golden sweep, card against the goldens")
    expected = ["SAL-DICT-ITER-1", "SAL-GUID-ITER-1", "SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1"]
    check(sorted(card["logs"]) == sorted(cpu["logs"]) == expected,
          "AL step logs %s / %s" % (sorted(card["logs"]), sorted(cpu["logs"])))
    for name in expected[1:]:
        check(card["logs"][name] == cpu["logs"][name], "%s differs from the CPU's" % name)
    _sal_dict_err(json.loads(card["logs"]["SAL-DICT-ITER-1"]),
                  json.loads(cpu["logs"]["SAL-DICT-ITER-1"]), "SAL-DICT-ITER-1")
    coreset = {}
    for features in ("POSE", "EMBEDDING"):
        tag = "CORESET %s step" % features
        got, ref = card[features], cpu[features]
        check(got["launches"]["min_distance_to_centers"] == 1,
              "%s: K2 launches %s" % (tag, got["launches"]))
        k2 = _coreset_k2(got["coreset"], dev, tag, float64_ref=features == "EMBEDDING")
        # The features the card ranked are the CPU's, and each greedy
        # pick wins by more than that difference can move a distance.
        x, y = (np.asarray(torch.as_tensor(run["coreset"].features).cpu()) for run in (got, ref))
        check(x.shape == y.shape and got["coreset"].n_sal == ref["coreset"].n_sal,
              "%s: features %s against the CPU's %s" % (tag, x.shape, y.shape))
        row_err = float(np.linalg.norm(x.astype(np.float64) - y, axis=-1).max())
        gaps = _greedy_gaps(x, got["coreset"].n_sal, GOLDEN_AL)
        check(min(gaps) > 4 * row_err,
              "%s: greedy gaps %s within 4 x %g of the CPU's features" % (tag, gaps, row_err))
        expected = ["SAL-DICT-ITER-1", "SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1"]
        check(sorted(got["logs"]) == sorted(ref["logs"]) == expected,
              "%s logs %s / %s" % (tag, sorted(got["logs"]), sorted(ref["logs"])))
        for name in expected[1:]:
            check(got["logs"][name] == ref["logs"][name], "%s: %s differs from the CPU's" % (tag, name))
        err = _sal_dict_err(json.loads(got["logs"]["SAL-DICT-ITER-1"]),
                            json.loads(ref["logs"]["SAL-DICT-ITER-1"]), tag + " SAL-DICT-ITER-1")
        coreset[features] = dict(sampled=json.loads(got["logs"]["SAMPLED-GUID-ITER-1"]),
                                 launches=got["launches"], k2=k2, feature_row_err=row_err,
                                 greedy_gaps=gaps, sal_dict_err_of_tol=err)
    return dict(golden="matched" if matched else "tree differs", card_cpu_err_of_tol=card_cpu,
                card_golden_err_of_tol=against_golden,
                sampled=json.loads(card["logs"]["SAMPLED-GUID-ITER-1"]),
                sal_guids=json.loads(card["logs"]["SAL-GUID-ITER-1"]),
                sweep_launches=card["sweep_launches"], coreset=coreset)


def _keyed(outs, keys):
    """score_step outputs as a sal_dict, keyed by (guids, frame_valid) a
    batch as _compute_sal_dict keys them."""
    sal = {metric: {} for metric in ("al_metric", "sal_metric", "inlier_count",
                                     "pred_3d_keypoints", "mkpe")}
    for out, (guids, frame_valid) in zip(outs, keys):
        out = {name: value.cpu().numpy() for name, value in out.items()}
        for i, guid in enumerate(guids):
            if frame_valid[i]:
                for metric in ("al_metric", "sal_metric", "inlier_count", "mkpe"):
                    sal[metric][guid] = float(out[metric][i])
                sal["pred_3d_keypoints"][guid] = out["keypoints_3d"][i].tolist()
    return sal


def _timed_sweep(strategy, pool, state):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sal = strategy._compute_sal_dict(pool, state)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, sal


def _check_sweep(sal, frames, tag):
    check(len(sal["al_metric"]) == frames, "%s: %d frames scored of %d"
          % (tag, len(sal["al_metric"]), frames))
    for metric in ("al_metric", "sal_metric", "mkpe"):
        check(all(np.isfinite(v) for v in sal[metric].values()), "%s: %s not finite" % (tag, metric))
    check(all(2 <= v <= VIEWS for v in sal["inlier_count"].values()), "%s: inlier counts" % tag)
    kp = np.asarray(list(sal["pred_3d_keypoints"].values()))
    check(kp.shape == (frames, JOINTS, 3) and bool(np.isfinite(kp).all()),
          "%s: keypoints %s" % (tag, kp.shape))


def phase_pool_sweep(dev, ctx):
    """The port's pool sweep and AL step through `ActiveLearningStrategy`,
    as users run them.  First on the golden tree against the CPU and the
    reference's goldens (`_golden_sweeps`).  Then at full width: the
    bench.py pool (64 frames x 31 cameras, 19 joints), PoseResNet-50 on the
    main path's weights, B=4, two decode workers and the native decoder, in
    the default configuration (int8) and in bf16 float: a cold sweep (new
    workers, started before the clock, and empty caches), a warm one (the
    launch counters set to 0 before it and read after: K1 once a batch;
    torch's sync debug mode must flag no synchronizing call in it; its
    sal_dict is the cold one's), the warm loader alone, and bare
    score_steps on the same engine and frames already on the card (their
    outputs keyed by guid give the warm sweep's sal_dict); then
    sample_next_batch at iteration 0 (random) and 1 (TRIANGULATION under
    SAL), and a CORESET step (K2 launched once, and held to its plain
    version on that step's features and mask).  Decode workers must not
    have initialized CUDA."""
    import shutil
    import tempfile
    import warnings

    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.data import build_dataset, native, pipeline
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        golden = _golden_sweeps(dev, tmp)
        t0 = time.perf_counter()
        tree = generate_panoptic_tree(os.path.join(tmp, "pool"), num_train_frames=SWEEP_FRAMES,
                                      num_val_frames=2, num_joints=JOINTS, num_cameras=VIEWS)
        tree_s = time.perf_counter() - t0
        state = ctx["state_dict"]
        batches = -(-SWEEP_FRAMES // BATCH)
        paths = {}
        for name, options in (("int8", {}), ("bf16", dict(TPU__INT8_SCORING=False))):
            cfg = _sweep_cfg(tree, JOINTS, os.path.join(tmp, name),
                             AL__INFERENCE__BATCH_SIZE=BATCH,
                             AL__INFERENCE__NUM_WORKERS=SWEEP_WORKERS, **options)
            strategy = ActiveLearningStrategy(cfg)  # the card: no device given
            check(strategy.device.type == "cuda" and strategy.engine.use_int8 == (name == "int8"),
                  "%s: device %s, int8 %s" % (name, strategy.device, strategy.engine.use_int8))
            pool = build_dataset(cfg, "train")
            pool.resample_unlabeled_data()
            # Cold: new workers with empty caches, started (and their
            # decoder loaded) before the clock, which times the sweep alone.
            pipeline.shutdown_shared_executors()
            pipeline.VIEW_CACHE.clear()
            t0 = time.perf_counter()
            ex = pipeline._shared_executor(SWEEP_WORKERS)
            for future in [ex.submit(pipeline.native_decoder_available)
                           for _ in range(SWEEP_WORKERS)]:
                future.result()
            workers_start_s = time.perf_counter() - t0
            cold_s, sal = _timed_sweep(strategy, pool, state)
            _check_sweep(sal, SWEEP_FRAMES, name + " cold sweep")
            kernels.reset_launch_counts()
            with warnings.catch_warnings(record=True) as syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    warm_s, warm = _timed_sweep(strategy, pool, state)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            launches = kernels.launch_counts()
            syncs = [str(w.message) for w in syncs
                     if "called a synchronizing CUDA operation" in str(w.message)]
            _check_sweep(warm, SWEEP_FRAMES, name + " warm sweep")
            # The same engine on the same frames: the warm sweep (workers
            # and caches warm, four batches in flight) gives the cold one's
            # sal_dict.
            warm_cold_err = _sal_dict_err(warm, sal, name + " warm sweep against cold")
            check(not syncs, "%s warm sweep: %d synchronizing calls, the first: %s"
                  % (name, len(syncs), syncs[:1]))
            check(launches["fused_decode"] == batches,
                  "%s sweep: K1 launched %d times for %d batches"
                  % (name, launches["fused_decode"], batches))

            # The warm loader alone (host prep, no engine), then bare
            # score_steps on the same engine and frames, on the card.
            t0 = time.perf_counter()
            loader_batches = sum(1 for _ in strategy._get_loader(pool, BATCH, SWEEP_WORKERS))
            loader_warm_s = time.perf_counter() - t0
            check(loader_batches == batches, "warm loader: %d batches" % loader_batches)
            engine = strategy.engine
            inputs, keys = [], []
            for b in strategy._get_loader(pool, BATCH, 0):
                inputs.append((strategy._device_images(b), strategy._put(b["proj_matrices"]),
                               strategy._put(b["joint_valid"]), strategy._put(b["3d_keypoints"])))
                keys.append((b["guid"], b["frame_valid"]))
            scales = engine.int8_calibrate(inputs[0][0])
            pairs = strategy._put(engine.pairs(VIEWS))

            def steps():
                return [engine.score_step(images, proj, valid, pairs, gt, int8_scales=scales)
                        for images, proj, valid, gt in inputs]

            bare_ms, _ = _timed_steps(steps, 1, 2)
            # The bare steps' outputs keyed by guid in this process: the
            # warm sweep (decode workers, pinned staging, four batches in
            # flight) must give the same sal_dict.
            bare_err = _sal_dict_err(warm, _keyed(steps(), keys), name + " warm sweep against bare steps")
            del inputs
            paths[name] = dict(
                workers_start_s=workers_start_s, loader_warm_s=loader_warm_s, cold_s=cold_s,
                cold_frames_per_s=SWEEP_FRAMES / cold_s, warm_s=warm_s,
                warm_frames_per_s=SWEEP_FRAMES / warm_s,
                bare_step_s=bare_ms / 1e3, bare_frames_per_s=SWEEP_FRAMES / (bare_ms / 1e3),
                host_share_of_warm=1.0 - (bare_ms / 1e3) / warm_s, batches=batches,
                launches=launches, synchronizing_calls=len(syncs),
                warm_cold_err_of_tol=warm_cold_err, warm_cold_equal=warm == sal,
                warm_bare_err_of_tol=bare_err)

            if name == "int8":
                # The AL step as users run it, then a CORESET step (K2).
                pool = build_dataset(cfg, "train")
                for iteration in (0, 1):
                    strategy.sample_next_batch(pool, SWEEP_AL, SWEEP_SAL, state, iteration)
                logs = _logs(cfg)
                check(len(json.loads(logs["SAMPLED-GUID-ITER-0"])) == SWEEP_AL
                      and len(json.loads(logs["SAMPLED-GUID-ITER-1"])) == SWEEP_AL,
                      "AL step logs %s" % sorted(logs))
                step_dict = json.loads(logs["SAL-DICT-ITER-1"])
                check(len(step_dict["al_metric"]) == SWEEP_FRAMES - SWEEP_AL,
                      "SAL-DICT-ITER-1 holds %d frames" % len(step_dict["al_metric"]))
                sal_guids = json.loads(logs.get("SAL-GUID-ITER-1", b"[]"))
                check(len(sal_guids) <= SWEEP_SAL, "SAL guids %s" % sal_guids)
                ccfg = _sweep_cfg(tree, JOINTS, os.path.join(tmp, "coreset"),
                                  AL__INFERENCE__BATCH_SIZE=BATCH,
                                  AL__INFERENCE__NUM_WORKERS=SWEEP_WORKERS,
                                  AL__STRATEGY="CORESET")
                coreset_launches, coreset_s, cs = _coreset_step(
                    ActiveLearningStrategy(ccfg), build_dataset(ccfg, "train"), SWEEP_AL, state)
                left = SWEEP_FRAMES - SWEEP_AL
                check(coreset_launches["fused_decode"] == -(-left // BATCH)
                      and coreset_launches["min_distance_to_centers"] == 1,
                      "CORESET step launches %s" % coreset_launches)
                check(cs.n_sal == left and cs.n_obs == SWEEP_FRAMES,
                      "CORESET step ranked %d candidates of %d rows" % (cs.n_sal, cs.n_obs))
                # K2 against its plain version on the step's own features
                # and mask.
                k2 = _coreset_k2(cs, dev, "full-width CORESET step")
                check(len(json.loads(_logs(ccfg)["SAMPLED-GUID-ITER-1"])) == SWEEP_AL,
                      "CORESET step picks")
                paths[name]["al_step"] = dict(
                    logs=sorted(logs), sampled_iter1=json.loads(logs["SAMPLED-GUID-ITER-1"]),
                    sal_guids=sal_guids, coreset_step_s=coreset_s,
                    coreset_launches=coreset_launches, coreset_k2=k2)

        # After the parent has used the card: the decode workers never have.
        ex = pipeline._shared_executor(SWEEP_WORKERS)
        worker_cuda = [ex.submit(pipeline.cuda_initialized).result() for _ in range(4)]
        worker_native = ex.submit(pipeline.native_decoder_available).result()
        check(not any(worker_cuda), "a decode worker initialized CUDA: %s" % worker_cuda)
    finally:
        pipeline.shutdown_shared_executors()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("pool_sweep", model="PoseResNet-50", frames=SWEEP_FRAMES, views=VIEWS, img=IMG,
         joints=JOINTS, batch=BATCH, workers=SWEEP_WORKERS,
         decoder="native" if native.available() else "PIL",
         worker_decoder="native" if worker_native else "PIL", worker_cuda_initialized=worker_cuda,
         tree_s=tree_s, paths=paths, golden_tree=golden,
         seconds=time.perf_counter() - t_phase)
    launches = {name: p["launches"] for name, p in paths.items()}
    launches["coreset"] = paths["int8"]["al_step"]["coreset_launches"]
    return launches, golden


def run_phases():
    """Every phase in order: (the card's name and power limit, the kernels
    line's rows, seconds)."""
    import torch

    sys.path.insert(0, REPO)
    from multi_view_active_learning_tpu_torch.ops.triangulate import all_view_pairs
    from multi_view_active_learning_tpu_torch.config import get_default_configs

    # Float32 means IEEE float32 here: cuDNN would otherwise run the float32
    # convolutions in TF32 (about three decimal digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi = phase_device()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows = [phase_k1(dev, flush), phase_k2(dev, flush), phase_k3(dev, flush), phase_k4(dev, flush)]
    phase_int8_conv(dev)
    phase_model(dev)
    phase_hrnet_model(dev)
    cfg = get_default_configs()
    pairs = all_view_pairs(VIEWS, cfg.AL.RANSAC_N_ITERS, int(cfg.RANDOM_SEED) & 0x7FFFFFFF)
    phase_triangulation(dev, pairs)
    launches, ctx = phase_main_path(dev)
    path_launches = phase_paths(dev, ctx)
    phase_hrnet_path(dev, ctx)
    phase_embedding(dev, ctx)
    sweep_launches, golden = phase_pool_sweep(dev, ctx)
    # Each kernel's launches on the path that drives it.
    launches["fused_deconv_bn_relu"] = path_launches["bf16_k3"]["fused_deconv_bn_relu"]
    launches["fused_deconv_bn_relu_int8"] = path_launches["int8_k4"]["fused_deconv_bn_relu_int8"]
    for row in rows:
        row["launches"] = launches[row["name"]]
    # K1 in a warm sweep of the default configuration, K2 in a CORESET step.
    rows[0]["sweep_launches"] = sweep_launches["int8"]["fused_decode"]
    rows[1]["sweep_launches"] = sweep_launches["coreset"]["min_distance_to_centers"]
    return smi, rows, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        smi, rows, seconds = run_phases()
    finally:
        t0 = time.perf_counter()
        left = stop_child_processes()
    check(not left, "processes left running at the end: %s" % left)
    emit("done", seconds=seconds, children_stopped_s=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
