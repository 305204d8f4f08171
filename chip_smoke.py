#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multi_view_active_learning_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card (K1 decode at bench width and on its ragged, misaligned and one-row
shapes; K2 coreset distance on the bench pool, its edge cases, feature
widths 1 to 2048 (bit for bit on exact grids at 512, 2047 and 2048), a
16384-row pool and the 2048 x 2048 EMBEDDING pool; K3 / K4 fused deconv head
at the head's three bench-width shapes; K5, the int8 conv unit, bit for bit
at every conv of PoseResNet-50 and HRNet-W32 at the sweep's 16 x 31 crops,
timed at PoseResNet-50's), PoseResNet-50 and HRNet-W32 against the
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
the ``kernels`` line also gives K1's and K5's launches in a warm sweep
(K5 53 a forward, and no ``torch._int_mm`` call) and K2's in the
full-width CORESET step (``sweep_launches``).  Then training
(``phase_train``) and the CLI (``phase_workflow``: ``workflow.main`` on the
card for the sample config's HRNet-W32 SAL experiment cut in depth,
PoseResNet-50 SUPERVISED with RandAugment and CLUSTER, and a CORESET run;
RandAugment on the card against the CPU), whose K1 and K2 launches the
``kernels`` line gives as ``workflow_launches``.  Last, data parallelism
(``phase_distributed``): that CORESET run in one process at batches of 4,
under a NCCL group of one (bit for bit the same), and as two gloo ranks
sharing the card at batches of 2 a rank (``chip_smoke.py --cli-rank``
processes), held to the one-process run, plus two NCCL ranks when there
are two cards; each rank's K1 and K2 launches are the ``kernels`` line's
``distributed_launches``.  Then view sharding (``phase_view_sharding``):
that run on a 16-camera tree in one process and as a 1 x 2 data x view
grid of gloo ranks sharing the card (plus a 2 x 2 NCCL grid with four
cards), held to the one-process run, K1 on each rank's own views
(``view_sharding_launches``).  The exact reformulation options
(``phase_reformulations``, after the EMBEDDING path): the space-to-depth
stem (float and int8), PhaseDeconv and HRNet's packed convs, each
reformulated layer against the standard one, the forwards, and their
score-step ms beside the standard's.  Training runs under cuDNN's
deterministic algorithms and replays bit for bit from one seed.  Serving
(``phase_serving``, after the EMBEDDING path): PoseResNet-50 artifacts (static B=4 and symbolic batch in bf16, the
int8 backbone with static scales, the K3 and K4 heads) and HRNet-W32 at
B=1 are exported with ``torch.export`` at full width, then loaded and
called at B=1 and 4 in a fresh process (``chip_smoke.py --serve-load``)
that refuses JAX and the port's engine, models and config; their outputs
are held to the eager serve function's and each call's launches are
counted there (K1 once, K3 / K4 three times, K5 53 times in the int8
artifacts: the ``kernels`` line's ``serving_launches``); tools/bench_serving_torch.py then times the bf16
and int8 artifacts.  Last, the tools that show the port learns
(``phase_learning``): tools/validate_learning_torch.py at its defaults
with --int8_compare must print VALIDATION PASSED.

Prints one JSON line per phase, the card's name and power limit as
nvidia-smi reports them, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  ``chip_smoke.py --phase k5 [k1 ...]``
runs the build and the named kernel phases alone.  Any failed check raises and exits
nonzero; without a CUDA device it exits nonzero and prints no result.
Before the last lines, and on any failure, it stops every process it
started (decode workers, their forkserver, multiprocessing's resource
tracker) and waits for them; a child still alive then fails the run.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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


# K5 at the main path's width: the sweep's scoring batch (16 frames x 31
# views) of 256x256 crops.
K5_CROPS = 16 * VIEWS


def _k5_units(model, crops):
    """Every K5 unit one int8 forward of `model` ("POSE_RESNET": PoseResNet-50,
    "HRNET": HRNet-W32) makes on [crops, IMG, IMG, 3], in order, as (n, h, w,
    cin, cout, k, stride, pad, relu, residual): from a forward on meta
    tensors with the unit replaced by a recorder."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import int8_conv
    from multi_view_active_learning_tpu_torch.models import PoseHighResolutionNet, PoseResNet
    from multi_view_active_learning_tpu_torch.models import quantize

    seen = []

    def record(x, wq, ws, scale, bias, act_scale, residual=None, stride=1, pad=None, relu=True):
        k = wq.shape[1]
        pad = (k // 2, k // 2) if pad is None else tuple(pad)
        seen.append((*x.shape, wq.shape[0], k, stride, pad, relu, residual is not None))
        ho, wo = int8_conv.out_hw(x.shape[1], x.shape[2], k, stride, pad)
        return torch.empty((x.shape[0], ho, wo, wq.shape[0]), dtype=torch.bfloat16, device="meta")

    net = PoseResNet(JOINTS, DEPTH) if model == "POSE_RESNET" else PoseHighResolutionNet(JOINTS)
    sd = {k: v.to("meta") for k, v in net.state_dict().items()}
    x = torch.empty((crops, IMG, IMG, 3), device="meta")
    real = int8_conv.int8_conv_bn
    int8_conv.int8_conv_bn = record
    try:
        if model == "POSE_RESNET":
            quantize.quantized_pose_resnet_forward(quantize.quantize_state_dict(sd, DEPTH), x, DEPTH)
        else:
            qp = quantize.quantize_state_dict(sd, 0, model_type="HRNET")
            quantize.quantized_hrnet_forward(qp, x, *net.stage_configs)
    finally:
        int8_conv.int8_conv_bn = real
    return seen


def _k5_operands(unit, dev, seed):
    """Seeded operands of one unit on the card: x bf16 about unit scale, s8
    weights, per-Cout scales, the folded BN, a residual."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import int8_conv

    n, h, w, cin, cout, k, stride, pad, _, _ = unit
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g, device=dev).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (cout, k, k, cin), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand(cout, generator=g, device=dev) * 1e-3 + 1e-4
    scale = torch.rand(cout, generator=g, device=dev) + 0.5
    bias = torch.randn(cout, generator=g, device=dev) * 0.1
    ho, wo = int8_conv.out_hw(h, w, k, stride, pad)
    res = torch.randn((n, ho, wo, cout), generator=g, device=dev).to(torch.bfloat16)
    return x, wq, ws, scale, bias, res


def _k5_bound(unit):
    """(bytes-bound ms, operations-bound ms) of one unit: x read once in
    bf16, the s8 weights once, the bf16 output written once, the residual
    read once; k*k*Cin*Cout multiply-adds an output pixel."""
    from multi_view_active_learning_tpu_torch.kernels import int8_conv

    n, h, w, cin, cout, k, stride, pad, _, residual = unit
    ho, wo = int8_conv.out_hw(h, w, k, stride, pad)
    nbytes = 2 * n * h * w * cin + cout * k * k * cin + 2 * n * ho * wo * cout * (2 if residual else 1)
    ops = 2 * n * ho * wo * k * k * cin * cout
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


def phase_k5(dev, flush):
    """K5 (kernels/int8_conv.py) against its plain twin on the card, bit for
    bit on the bf16 output, at every conv unit of PoseResNet-50 and at each
    distinct unit of HRNet-W32 at the sweep's batch (16 x 31 crops of
    256x256), with a dynamic scale (max|x| / 127 on the card) and a static
    one that clips, with and without a residual.  Timed at PoseResNet-50's
    units (a forward's 53, repeats counted): `ms` the unit (its pre-pass
    and product), `plain_ms` the twin, `library_ms` the twin's
    torch._int_mm products alone; the bound from bytes and operations.  A
    forward at static and dynamic scales makes no synchronizing call."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.kernels import int8_conv
    from multi_view_active_learning_tpu_torch.ops.int8 import int8_matmul

    t_phase = time.perf_counter()
    resnet = _k5_units("POSE_RESNET", K5_CROPS)
    hrnet = _k5_units("HRNET", K5_CROPS)
    check(len(resnet) == 53, "PoseResNet-50 makes %d units, want 53" % len(resnet))
    checked, mismatched = 0, {}
    for model, units in (("POSE_RESNET", resnet), ("HRNET", hrnet)):
        for idx, unit in enumerate(sorted(set(units))):
            x, wq, ws, scale, bias, res = _k5_operands(unit, dev, 50 + idx)
            n, h, w, cin, cout, k, stride, pad, relu, _ = unit
            dynamic = torch.amax(torch.abs(x.float())) / 127.0
            static = torch.tensor(0.012, device=dev)  # clips: max|x| is about 5
            for sx in (dynamic, static):
                for r in (None, res):
                    got = int8_conv.int8_conv_bn(x, wq, ws, scale, bias, sx, r, stride, pad, relu)
                    ref = int8_conv.int8_conv_bn_plain(x, wq, ws, scale, bias, sx, r, stride, pad,
                                                       relu)
                    torch.cuda.synchronize()
                    checked += 1
                    if not torch.equal(got, ref):
                        mismatched["%s %s %s %s" % (model, unit, "dynamic" if sx is dynamic
                                                    else "static", r is not None)] = int(
                            torch.sum(got != ref))
            del x, wq, ws, scale, bias, res, got, ref
        torch.cuda.empty_cache()
    check(not mismatched, "K5 differs from its twin: %s" % mismatched)
    x, wq, ws, scale, bias, _ = _k5_operands(resnet[1], dev, 49)
    empty = int8_conv.int8_conv_bn(x[:0], wq, ws, scale, bias, torch.tensor(0.02, device=dev))
    check(tuple(empty.shape) == (0,) + tuple(x.shape[1:3]) + (wq.shape[0],),
          "K5 on an empty batch: %s" % (tuple(empty.shape),))
    del x, wq, ws, scale, bias, empty

    # Times at PoseResNet-50's units, each distinct shape once, weighted by
    # how often a forward runs it.
    per_shape = []
    for idx, unit in enumerate(sorted(set(resnet), key=resnet.index)):
        x, wq, ws, scale, bias, res = _k5_operands(unit, dev, 90 + idx)
        n, h, w, cin, cout, k, stride, pad, relu, residual = unit
        r = res if residual else None
        sx = torch.amax(torch.abs(x.float())) / 127.0
        cols = int8_conv.im2col(int8_conv.quant_act(x, sx), k, stride, pad)
        a = cols.reshape(-1, cols.shape[-1])
        b = wq.reshape(cout, -1)
        b_bytes, b_ops = _k5_bound(unit)
        entry = dict(
            unit=list(unit[:5]) + [k, stride, list(pad), relu, residual], count=resnet.count(unit),
            plan=dict(tile_n=int8_conv.tile_n_for(cout),
                      tiles=int8_conv.conv_plan(n, h, w, cin, cout, k, stride, pad[0], pad[1],
                                                relu).tiles),
            ms=cuda_ms(lambda: int8_conv.int8_conv_bn(x, wq, ws, scale, bias, sx, r, stride, pad,
                                                      relu), 10, flush),
            plain_ms=cuda_ms(lambda: int8_conv.int8_conv_bn_plain(x, wq, ws, scale, bias, sx, r,
                                                                  stride, pad, relu), 3, flush),
            library_ms=cuda_ms(lambda: int8_matmul(a, b), 3, flush),
            bound_bytes_ms=b_bytes, bound_ops_ms=b_ops)
        entry["share_of_bound"] = _share(entry)
        per_shape.append(entry)
        del x, wq, ws, scale, bias, res, cols, a, b
    torch.cuda.empty_cache()

    def total(key):
        return sum(e[key] * e["count"] for e in per_shape)

    bytes_ms, ops_ms = total("bound_bytes_ms"), total("bound_ops_ms")
    bound_ms = sum(max(e["bound_bytes_ms"], e["bound_ops_ms"]) * e["count"] for e in per_shape)
    row = dict(name="int8_conv_bn", route="cuda", source="multi_view_active_learning_tpu_torch/csrc/int8_conv.cu",
               replaces="none (the JAX package leaves the int8 conv to XLA)",
               max_abs_err=0.0, ms=total("ms"), plain_ms=total("plain_ms"),
               bound_ms=bound_ms, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               library_ms=total("plain_ms"))

    # A forward makes no synchronizing call, at static or dynamic scales.
    from multi_view_active_learning_tpu_torch.models import PoseResNet, quantize

    state = random_state_dict(PoseResNet(JOINTS, DEPTH), seed=7)
    qp = quantize.quantize_state_dict({k: v.to(dev) for k, v in state.items()}, DEPTH)
    images = torch.randn((BATCH * VIEWS, IMG, IMG, 3), device=dev)
    _, table = quantize.quantized_pose_resnet_forward(qp, images, DEPTH, collect_scales=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        quantize.quantized_pose_resnet_forward(qp, images, DEPTH, act_scales=table)
        quantize.quantized_pose_resnet_forward(qp, images, DEPTH)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["int8_conv_bn"]
    check(launches == 2 * 53, "K5 launched %d times in two forwards, want 106" % launches)
    emit("k5", units_checked=checked, bit_equal=True, resnet_units=len(resnet),
         hrnet_units=len(hrnet), hrnet_distinct=len(set(hrnet)), crops=K5_CROPS, per_shape=per_shape,
         ms=row["ms"], plain_ms=row["plain_ms"], library_ms=row["library_ms"],
         int_mm_ms=total("library_ms"), bound_ms=bound_ms, bound_bytes_ms=bytes_ms,
         bound_ops_ms=ops_ms, bound_by=row["bound_by"], share_of_bound=bound_ms / row["ms"],
         forward_launches=launches // 2, synchronizing_calls=0, ptxas=_ptxas("int8_conv.cu"),
         seconds=time.perf_counter() - t_phase)
    return row


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
    for name in ("fused_deconv_bn_relu", "fused_deconv_bn_relu_int8", "int8_conv_bn"):
        check(launches[name] == 0, "kernel %s launched on the float standard-head path" % name)
    emit("main_path", batch=BATCH, views=VIEWS, img=IMG, joints=JOINTS, depth=DEPTH,
         pairs=len(pairs), steps=steps, coreset_ms=coreset_ms, pool=POOL, pick=PICK,
         bf16_step_ms=steps["bfloat16"]["step_ms"],
         bf16_step_ms_before_registered_ops=PARENT_BF16_STEP_MS,
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
        want = 53 * forwards if scales is not None else 0  # K5: a unit a conv
        check(launches["int8_conv_bn"] == want, "%s: int8_conv_bn launched %d times, want %d"
              % (name, launches["int8_conv_bn"], want))
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
    hr_units = len(_k5_units("HRNET", BATCH * VIEWS))  # a forward's; 1 + 4 + 4 forwards
    check(int8_launches["int8_conv_bn"] == 9 * hr_units,
          "hrnet int8: K5 launches %s, want %d" % (int8_launches, 9 * hr_units))
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
# The exact reformulation options (phase_reformulations).  Each
# reformulated layer, as the option's forward meets it, against the
# standard layer on the same input: float32 (TF32 off) within the goldens'
# rtol of 1e-4 of the output's scale, bf16 within one bf16 step (2^-7) of
# it.  The whole forward against the standard engine's: float32 within
# 1e-4 of the scale; bf16 at the bar of the K3 path, another way of
# computing a bf16 layer (K3_PATH_*): each layer's output rounds to bf16 on
# its own, and 50 layers carry those roundings on (the space-to-depth
# stem's forward measured 1.59e-2 of the scale on the card).  The int8
# stem's s32 products equal.
REFORM_F32_TOL, REFORM_BF16_TOL = 1e-4, 2.0**-7
REFORM_OPTIONS = [("SPACE_TO_DEPTH_STEM", "POSE_RESNET", dict(SPACE_TO_DEPTH_STEM=True)),
                  ("FAST_DECONV", "POSE_RESNET", dict(FAST_DECONV=True)),
                  ("HRNET_PACKED_MAX_CH", "HRNET", dict(HRNET_PACKED_MAX_CH=32))]


def _reformulated_layer_errs(engine, images):
    """Each reformulated layer of `engine`'s model (the stem on a
    space-to-depth input, PhaseDeconv, PackedConv2d) against the standard
    layer on the input it meets in ``engine.forward(images)``: the largest
    error of each over its output's scale."""
    import torch
    import torch.nn.functional as F
    from multi_view_active_learning_tpu_torch.models.pose_resnet import (
        PackedConv2d, PhaseDeconv, SpaceToDepthStem)

    errs = []

    def compare(module, inputs, out):
        x = inputs[0]
        w = module.weight.to(x.dtype)
        if isinstance(module, PhaseDeconv):
            ref = F.conv_transpose2d(x, w, stride=2, padding=1)
        elif isinstance(module, PackedConv2d):
            ref = F.conv2d(x, w, padding=1)
        elif x.shape[1] == 4 * module.in_channels:  # the stem on space-to-depth'd frames
            n, c4, h, wd = x.shape
            plain = x.reshape(n, 2, 2, c4 // 4, h, wd).permute(0, 3, 4, 1, 5, 2)
            ref = F.conv2d(plain.reshape(n, c4 // 4, 2 * h, 2 * wd), w, stride=2, padding=3)
        else:
            return
        errs.append(float((out - ref).abs().max()) / float(ref.abs().max()))

    handles = [m.register_forward_hook(compare) for m in engine.model.modules()
               if isinstance(m, (SpaceToDepthStem, PackedConv2d, PhaseDeconv))]
    try:
        with torch.inference_mode():
            engine.forward(images)
    finally:
        for handle in handles:
            handle.remove()
    return errs


def phase_reformulations(dev, ctx):
    """TPU.SPACE_TO_DEPTH_STEM, TPU.FAST_DECONV (PoseResNet-50) and
    TPU.HRNET_PACKED_MAX_CH 32 (HRNet-W32) at bench width, the main path's
    seeded weights (HRNet's of the HRNet path), in bf16 and float32: each
    option's reformulated layers and its forward against the standard
    ones on the main path's frames (REFORM_*), and its TRIANGULATION
    score-step ms beside the standard one's,
    timed in turns (standard, option, option, standard).  Then the int8
    stem (the default configuration, static scales) on the space-to-depth
    input: its K5 unit's output equals the plain stem's, and the heatmaps
    are printed against the plain int8 path's."""
    import torch
    from multi_view_active_learning_tpu_torch.kernels import int8_conv
    from multi_view_active_learning_tpu_torch.models import quantize

    t_phase = time.perf_counter()
    images, proj, valid, pairs, gt = (ctx[k] for k in ("images", "proj", "valid", "pairs", "gt"))
    weights = {"POSE_RESNET": ctx["state_dict"], "HRNET": hrnet_state_dict()}
    rows = []
    for option, model, tpu in REFORM_OPTIONS:
        for dtype in ("bfloat16", "float32"):
            std = _engine(dtype, dev, weights[model], model)
            opt = _engine(dtype, dev, weights[model], model, **tpu)
            layer_errs = _reformulated_layer_errs(opt, images)
            tol = REFORM_F32_TOL if dtype == "float32" else REFORM_BF16_TOL
            check(layer_errs and max(layer_errs) <= tol,
                  "%s %s: %d reformulated layers, off the standard layer by up to %s of the "
                  "scale (bar %g)" % (option, dtype, len(layer_errs), max(layer_errs or [0]), tol))
            cos, err, agree = _agreement(opt.forward(images), std.forward(images))
            if dtype == "float32":
                check(err <= REFORM_F32_TOL, "%s float32: forward off the standard one by %g of "
                      "the scale" % (option, err))
            else:
                check(cos > K3_PATH_COS and err <= K3_PATH_MAX_ERR,
                      "%s bf16: forward against the standard one: cosine %g, max err %g of the "
                      "scale" % (option, cos, err))
            ms = {"standard": [], "option": []}
            for which in ("standard", "option", "option", "standard"):
                engine = std if which == "standard" else opt
                step_ms, out = _timed_steps(
                    lambda: engine.score_step(images, proj, valid, pairs, gt), 2, 10)
                _check_scores(out, "%s %s %s" % (option, dtype, which))
                ms[which].append(step_ms)
            rows.append(dict(option=option, model=model, dtype=dtype, layers=len(layer_errs),
                             layer_max_err_of_scale=max(layer_errs), layer_tol=tol,
                             forward_err_of_scale=err, forward_cosine=cos,
                             forward_argmax_agreement=agree, standard_ms=ms["standard"],
                             option_ms=ms["option"]))
            del std, opt
    # The int8 stem on space-to-depth'd frames, static scales.
    std = _engine("bfloat16", dev, weights["POSE_RESNET"], INT8_SCORING=True)
    opt = _engine("bfloat16", dev, weights["POSE_RESNET"], INT8_SCORING=True,
                  SPACE_TO_DEPTH_STEM=True)
    check(std.use_int8 and opt.use_int8, "the int8 engines score float")
    scales = std.int8_calibrate(images)
    with torch.inference_mode():
        flat, flat_s2d = std._flatten_normalize(images), opt._flatten_normalize(images)
        sx = scales["stem"]
        stem = []
        for engine, x in ((std, flat), (opt, flat_s2d)):  # the stem's K5 unit on each
            qp = engine._int8_weights
            wq, stride, pad = quantize._stem_conv(qp["conv1.wq"], x.shape[-1])
            stem.append(int8_conv.int8_conv_bn(x.to(torch.bfloat16).contiguous(), wq,
                                               qp["conv1.ws"], qp["bn1.scale"], qp["bn1.bias"], sx,
                                               None, stride, pad))
    check(torch.equal(stem[0], stem[1]),
          "int8 stem: K5's outputs differ on the space-to-depth input")
    cos, int8_err, agree = _agreement(opt.forward(images, scales), std.forward(images, scales))
    ms = {"standard": [], "option": []}
    for which in ("standard", "option", "option", "standard"):
        engine = std if which == "standard" else opt
        step_ms, out = _timed_steps(
            lambda: engine.score_step(images, proj, valid, pairs, gt, int8_scales=scales), 2, 10)
        _check_scores(out, "int8 s2d %s" % which)
        ms[which].append(step_ms)
    rows.append(dict(option="SPACE_TO_DEPTH_STEM", model="POSE_RESNET", dtype="int8",
                     stem_unit_equal=True, forward_err_of_scale=int8_err, forward_cosine=cos,
                     forward_argmax_agreement=agree, standard_ms=ms["standard"],
                     option_ms=ms["option"]))
    emit("reformulations", batch=BATCH, views=VIEWS, img=IMG, joints=JOINTS, rows=rows,
         tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
         seconds=time.perf_counter() - t_phase)


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
    return _set_options(cfg, options)


def _set_options(cfg, options):
    """Set {"NODE__KEY": value} options on `cfg`."""
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


def _with_spans(run):
    """`run()` under a profiler session of the card's activity alone, as the
    benchmark's traced window: (its result, the program's span records,
    each with the synchronizing calls charged to it)."""
    import torch
    from multi_view_active_learning_tpu_torch.utils import profiling

    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        out = run()
    records = profiling.span_records()
    profiling.clear_spans()
    return out, records


def _synced_spans(records, skip=()):
    """The name of the span charged with each synchronizing call that
    torch's sync debug mode flagged (``profiling.host_waits``' syncs),
    leaving out the spans inside one named in `skip`."""
    left_out, names = set(), []
    for i, r in enumerate(records):  # a span opens after its parent
        if r.name in skip or r.parent in left_out:
            left_out.add(i)
        else:
            names += [r.name] * r.syncs
    return names


class _counting_int_mm:
    """Counts the calls of torch._int_mm (the library's s8 product) while
    the block runs: ``with _counting_int_mm() as calls: ...; calls[0]``."""

    def __enter__(self):
        import torch

        self.real, self.calls = torch._int_mm, [0]

        def counted(*args, **kwargs):
            self.calls[0] += 1
            return self.real(*args, **kwargs)

        torch._int_mm = counted
        return self.calls

    def __exit__(self, *exc):
        import torch

        torch._int_mm = self.real
        return False


def _check_sweep(sal, frames, tag):
    check(len(sal["al_metric"]) == frames, "%s: %d frames scored of %d"
          % (tag, len(sal["al_metric"]), frames))
    for metric in ("al_metric", "sal_metric", "mkpe"):
        check(all(np.isfinite(v) for v in sal[metric].values()), "%s: %s not finite" % (tag, metric))
    check(all(2 <= v <= VIEWS for v in sal["inlier_count"].values()), "%s: inlier counts" % tag)
    kp = np.asarray(list(sal["pred_3d_keypoints"].values()))
    check(kp.shape == (frames, JOINTS, 3) and bool(np.isfinite(kp).all()),
          "%s: keypoints %s" % (tag, kp.shape))


def phase_pool_sweep(dev, ctx, tmp):
    """The port's pool sweep and AL step through `ActiveLearningStrategy`,
    as users run them.  First on the golden tree against the CPU and the
    reference's goldens (`_golden_sweeps`).  Then at full width: the
    bench.py pool (64 frames x 31 cameras, 19 joints), PoseResNet-50 on the
    main path's weights, B=4, two decode workers and the native decoder, in
    the default configuration (int8) and in bf16 float: a cold sweep (new
    workers, started before the clock, and empty caches), a warm one (the
    launch counters set to 0 before it and read after: K1 once a batch;
    torch's sync debug mode must flag no synchronizing call in it; its
    sal_dict is the cold one's; the synchronizing calls counted by the
    program's spans on one more warm sweep, untimed, under a profiler
    session), the warm loader alone, and bare
    score_steps on the same engine and frames already on the card (their
    outputs keyed by guid give the warm sweep's sal_dict); then
    sample_next_batch at iteration 0 (random) and 1 (TRIANGULATION under
    SAL), and a CORESET step (K2 launched once, and held to its plain
    version on that step's features and mask).  Decode workers must not
    have initialized CUDA."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.data import build_dataset, native, pipeline
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy

    t_phase = time.perf_counter()
    try:
        golden = _golden_sweeps(dev, tmp)
        t0 = time.perf_counter()
        tree = generate_panoptic_tree(os.path.join(tmp, "pool"), num_train_frames=SWEEP_FRAMES,
                                      num_val_frames=TRAIN_VAL_FRAMES, num_joints=JOINTS,
                                      num_cameras=VIEWS)
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
            with _counting_int_mm() as int_mm:
                warm_s, warm = _timed_sweep(strategy, pool, state)
            launches = kernels.launch_counts()
            # The sync check on one more warm sweep, untimed: the profiler
            # session's cost a launch stays out of warm_s.
            spanned, records = _with_spans(lambda: strategy._compute_sal_dict(pool, state))
            syncs = _synced_spans(records)
            check(sum(r.name == "sweep.dispatch" for r in records) == batches,
                  "%s warm sweep: spans %s" % (name, sorted({r.name for r in records})))
            _check_sweep(warm, SWEEP_FRAMES, name + " warm sweep")
            _sal_dict_err(spanned, warm, name + " warm sweep under the profiler against warm")
            # The same engine on the same frames: the warm sweep (workers
            # and caches warm, four batches in flight) gives the cold one's
            # sal_dict.
            warm_cold_err = _sal_dict_err(warm, sal, name + " warm sweep against cold")
            check(not syncs, "%s warm sweep: %d synchronizing calls, in spans %s"
                  % (name, len(syncs), sorted(set(syncs))))
            check(launches["fused_decode"] == batches,
                  "%s sweep: K1 launched %d times for %d batches"
                  % (name, launches["fused_decode"], batches))
            # K5 a conv of every forward (the batches and the calibration),
            # and no s8 product of the library's.
            want = 53 * (batches + 1) if name == "int8" else 0
            check(launches["int8_conv_bn"] == want and int_mm[0] == 0,
                  "%s sweep: K5 launched %d times, want %d; torch._int_mm called %d times"
                  % (name, launches["int8_conv_bn"], want, int_mm[0]))

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
                launches=launches, int_mm_calls=int_mm[0], synchronizing_calls=len(syncs),
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
    emit("pool_sweep", model="PoseResNet-50", frames=SWEEP_FRAMES, views=VIEWS, img=IMG,
         joints=JOINTS, batch=BATCH, workers=SWEEP_WORKERS,
         decoder="native" if native.available() else "PIL",
         worker_decoder="native" if worker_native else "PIL", worker_cuda_initialized=worker_cuda,
         tree_s=tree_s, paths=paths, golden_tree=golden,
         seconds=time.perf_counter() - t_phase)
    launches = {name: p["launches"] for name, p in paths.items()}
    launches["coreset"] = paths["int8"]["al_step"]["coreset_launches"]
    return launches, golden, tree


# Training (phase_train).  Full width: PoseResNet-50 in bf16 (the default
# compute dtype) on the pool sweep's 31-view tree, B=2 frames (the config's
# TRAIN.BATCH_SIZE), 20 of its frames labeled (one epoch is then 10 steps,
# so a run resumed at step 10 sees the batches the uninterrupted run saw),
# 20 steps with a log point every 10, 8 validation frames.
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_VAL_FRAMES = 2, 20, 8
TRAIN_STEPS, TRAIN_LOG_EVERY, TRAIN_LR = 20, 10, 1e-3
# The card against the CPU: PoseResNet-18 at 64x64, 2 frames x 4 views, 4
# joints, float32 with TF32 off.  LR 1e-5: Adam moves a weight ~lr *
# sign(g) a step, and the sign of a near-zero gradient is float noise that
# differs between cuDNN and the CPU, so the weights may differ by 2 * lr a
# step (PARITY_PARAM_STEPS of them); the losses within rtol 1e-4.  The BN
# statistics after 3 steps at a step where the LR has decayed to 0
# (LR * 0.1 ** 50 in float32), within 1e-5 + 1e-5 of their size.
PARITY_IMG, PARITY_VIEWS, PARITY_JOINTS, PARITY_LR = 64, 4, 4, 1e-5
PARITY_FROZEN_STEP = 3000 * 50
PARITY_LOSS_RTOL, PARITY_BN_TOL = 1e-4, 1e-5
# A resumed run against the uninterrupted one: 10 steps after the resume,
# each within Adam's 2 * lr sign noise (cuDNN's weight gradients sum in an
# order that is not fixed).
RESUME_PARAM_TOL = 2 * TRAIN_LR * (TRAIN_STEPS - TRAIN_LOG_EVERY)
# TPU.REMAT against no REMAT, one full-width step: the same loss (rtol), and
# BN statistics folded once (twice would move them by 0.1 of |batch - old|,
# about 0.1 here).
REMAT_LOSS_RTOL, REMAT_BN_TOL = 1e-3, 1e-3
# The stale-weights check: the strategy's engine after training against a
# new Engine loaded with the trained weights, on one batch.
STALE_TOL = 1e-4


def _parity_batch(seed):
    import torch
    from multi_view_active_learning_tpu_torch.ops.heatmap import render_gaussian_heatmaps

    rng = np.random.default_rng(seed)
    b, v, k, img = 2, PARITY_VIEWS, PARITY_JOINTS, PARITY_IMG
    images = rng.normal(size=(b, v, img, img, 3)).astype(np.float32)
    kp = torch.from_numpy(rng.uniform(2, img - 2, size=(b, v, k, 2)).astype(np.float32))
    gt = render_gaussian_heatmaps(kp / 4, img // 4, img // 4, 2.0).numpy()
    return images, gt, rng.random((b, v, k)) > 0.2, np.ones(b, bool)


def _parity_engine(device, **train):
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.engine import Engine

    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = PARITY_JOINTS
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = PARITY_IMG
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.TRAIN.OPTIM.LR = PARITY_LR
    for key, value in train.items():
        setattr(cfg.TRAIN, key, value)
    return Engine(cfg, device=device)


def _train_parity(dev):
    """(a): three train_steps on the card and on the CPU from the same
    init_state weights and batch; three at a frozen LR for the BN
    statistics; a forced skip on the card."""
    import torch

    batch = _parity_batch(12)
    init = _parity_engine("cpu").init_state(torch.Generator().manual_seed(0)).state_dict()
    runs = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        engine = _parity_engine(device)
        state, losses = engine.state_from_state_dict(init), []
        for _ in range(3):
            state, metrics = engine.train_step(state, *batch)
            check(not bool(metrics["skipped"]), "%s parity step skipped" % name)
            losses.append(float(metrics["loss"]))
        frozen = engine.state_from_state_dict(init, step=PARITY_FROZEN_STEP)
        for _ in range(3):
            frozen, metrics = engine.train_step(frozen, *batch)
            check(float(metrics["lr"]) == 0.0, "the frozen LR is %g" % float(metrics["lr"]))
        runs[name] = dict(losses=losses, params=state.clone_to("cpu").params,
                          buffers=frozen.clone_to("cpu").buffers)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs["card"]["losses"],
                                                      runs["cpu"]["losses"]))
    param_err = max(float((runs["card"]["params"][n] - p).abs().max())
                    for n, p in runs["cpu"]["params"].items())
    bn_err = max(float(((runs["card"]["buffers"][n] - b).abs()
                        / (PARITY_BN_TOL + PARITY_BN_TOL * b.abs())).max())
                 for n, b in runs["cpu"]["buffers"].items())
    check(loss_err <= PARITY_LOSS_RTOL, "card losses off the CPU's by %g relative" % loss_err)
    check(param_err <= 3 * 2 * PARITY_LR, "card weights off the CPU's by %g" % param_err)
    check(bn_err <= 1.0, "card BN statistics off the CPU's by %g of the tolerance" % bn_err)

    engine = _parity_engine(dev, LOSS_CLIP_VALUE=0.0)
    state = engine.state_from_state_dict(init)
    before = {k: v.clone() for k, v in state.flat.items()}
    count = int(state.count)
    state, metrics = engine.train_step(state, *batch)
    check(bool(metrics["skipped"]), "a loss above LOSS_CLIP_VALUE=0 was not skipped")
    check(all(torch.equal(before[k], state.flat[k]) for k in before)
          and int(state.count) == count and int(state.step) == 1,
          "a skipped step changed the state (or did not advance the step)")
    return dict(card_losses=runs["card"]["losses"], cpu_losses=runs["cpu"]["losses"],
                loss_rel_err=loss_err, param_max_err=param_err,
                param_tol=3 * 2 * PARITY_LR, bn_err_of_tol=bn_err, skip_bit_equal=True)


def _train_cfg(tree, log_dir, name, **options):
    return _sweep_cfg(tree, JOINTS, log_dir, EXPR_NAME=name, TRAIN__BATCH_SIZE=TRAIN_BATCH,
                      TRAIN__FULLY_SUPERVISED_FRAME_COUNT=TRAIN_FRAMES, DATA__EPOCH_SIZE=0,
                      TRAIN__LOG_EVERY_ITER=TRAIN_LOG_EVERY, TRAIN__VAL_SIZE=TRAIN_VAL_FRAMES,
                      TRAIN__OPTIM__TOTAL_STEPS=TRAIN_STEPS, TRAIN__OPTIM__LR=TRAIN_LR,
                      **options)


class _TrainSpy:
    """Wraps a strategy's train_step: keeps every step's loss and skip flag
    on the card (nothing is fetched)."""

    def __init__(self, strategy):
        self.steps, self.losses, self.skipped = 0, [], []
        engine_step = strategy.engine.train_step

        def train_step(state, *args):
            state, metrics = engine_step(state, *args)
            self.steps += 1
            self.losses.append(metrics["loss"])
            self.skipped.append(metrics["skipped"])
            return state, metrics

        strategy.engine.train_step = train_step
        self._strategy = strategy

    def remove(self):
        del self._strategy.engine.train_step


def _ckpt_steps(cfg):
    d = os.path.join(cfg.LOG_DIR, cfg.EXPR_NAME, "FULLY_SUPERVISED", "checkpoints")
    return d, sorted(os.listdir(d))


def phase_train(dev, tree, tmp):
    """Training through the port's entry points.  (a) `_train_parity`.
    (b) `run_fully_supervised_training` at full width on the pool sweep's
    tree: every loss finite and no step skipped, K1 launched once per eval
    batch (two log points), CKPT-E10 / CKPT-E20 / CKPT-FINAL written, no
    synchronizing call flagged between log points (the program's spans
    under a profiler session, so `run_s` includes the session's cost a
    launch: none charged to a span inside ``train`` outside its
    ``train.log_point`` spans, and at most one to ``train`` itself, whose
    start reads the state's step); a run resumed from
    CKPT-E10 (TRAIN.RESTORE_FROM) reaches the uninterrupted run's step-20
    weights within RESUME_PARAM_TOL; after training the strategy's engine
    scores a batch as a new Engine loaded with the trained weights does
    (and not as the initial weights do); TPU.REMAT gives one step's loss and
    BN statistics.  The run is under cuDNN's deterministic algorithms, as
    the CLI trains (``device.use_deterministic_algorithms``), and a second
    run from the same seed must end in the same state bit for bit (ROADMAP
    Queue C9).  (c) step ms, frames/s and crops/s on batches already on the
    card, eval and checkpoint-save seconds, peak memory with and without
    REMAT; the step with and without the deterministic flags, in turns; the
    ops of a step that ``torch.use_deterministic_algorithms`` would flag."""
    import warnings

    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.data import build_dataset, pipeline
    from multi_view_active_learning_tpu_torch.device import use_deterministic_algorithms
    from multi_view_active_learning_tpu_torch.engine import Engine
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy
    from multi_view_active_learning_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    parity = _train_parity(dev)
    use_deterministic_algorithms(dev)
    log_dir = os.path.join(tmp, "train")
    cfg = _train_cfg(tree, log_dir, "full")
    strategy = ActiveLearningStrategy(cfg)  # the card: no device given
    check(strategy.device.type == "cuda", "training on %s" % strategy.device)
    state0 = strategy.new_state()
    init_weights = {k: v.clone() for k, v in state0.state_dict().items()}
    spy = _TrainSpy(strategy)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        state, records = _with_spans(lambda: strategy.run_fully_supervised_training(
            state0, build_dataset(cfg, "train"), build_dataset(cfg, "val")))
    finally:
        spy.remove()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    syncs = _synced_spans(records, skip=("train.log_point",))
    own = syncs.count("train")  # the start's read of state.step
    syncs = [n for n in syncs if n != "train"]
    check(sum(r.name == "train.step" for r in records) == TRAIN_STEPS
          and sum(r.name == "train.log_point" for r in records) == TRAIN_STEPS // TRAIN_LOG_EVERY,
          "training spans %s" % sorted({r.name for r in records}))
    losses = torch.stack(spy.losses).float().cpu()
    skipped = int(torch.stack(spy.skipped).sum())
    check(spy.steps == TRAIN_STEPS and int(state.step) == TRAIN_STEPS,
          "trained %d steps (state step %d)" % (spy.steps, int(state.step)))
    check(bool(torch.isfinite(losses).all()), "non-finite losses %s" % losses.tolist())
    check(skipped == 0, "%d steps skipped" % skipped)
    eval_batches = -(-TRAIN_VAL_FRAMES // TRAIN_BATCH) * (TRAIN_STEPS // TRAIN_LOG_EVERY)
    check(launches["fused_decode"] == eval_batches,
          "K1 launched %d times for %d eval batches" % (launches["fused_decode"], eval_batches))
    check(not syncs and own <= 1, "%d synchronizing calls between log points, in spans %s; "
          "%d charged to train itself" % (len(syncs), sorted(set(syncs)), own))
    ckpt_dir, names = _ckpt_steps(cfg)
    e10 = [n for n in names if n.startswith("CKPT-E%d-MKPE" % TRAIN_LOG_EVERY)]
    check(len(e10) == 1 and any(n.startswith("CKPT-E%d-MKPE" % TRAIN_STEPS) for n in names)
          and "CKPT-FINAL" in names, "checkpoints %s" % names)
    with open(os.path.join(log_dir, "full", "FULLY_SUPERVISED", "summary", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    mkpe = [r["value"] for r in records if r["tag"] == "3D MKPE"]
    check(len(mkpe) == TRAIN_STEPS // TRAIN_LOG_EVERY and all(np.isfinite(mkpe)),
          "3D MKPE records %s" % mkpe)

    # The same run again from the same seed: the same state, bit for bit.
    acfg = _train_cfg(tree, log_dir, "again")
    again = ActiveLearningStrategy(acfg)
    replay = again.run_fully_supervised_training(
        again.new_state(), build_dataset(acfg, "train"), build_dataset(acfg, "val"))
    replay_diff = {k: float((replay.flat[k].double() - state.flat[k].double()).abs().max())
                   for k in state.flat}
    check(all(torch.equal(replay.flat[k], state.flat[k]) for k in state.flat)
          and int(replay.step) == int(state.step) and int(replay.count) == int(state.count),
          "two runs from one seed differ: %s" % replay_diff)
    del again, replay

    # Resumed from CKPT-E10: the same frames in the same order after it.
    rcfg = _train_cfg(tree, log_dir, "resumed",
                      TRAIN__RESTORE_FROM=os.path.join(ckpt_dir, e10[0]))
    resumer = ActiveLearningStrategy(rcfg)
    resumed = resumer.run_fully_supervised_training(
        resumer.new_state(salt=1), build_dataset(rcfg, "train"), build_dataset(rcfg, "val"))
    check(int(resumed.step) == TRAIN_STEPS, "resumed run ended at step %d" % int(resumed.step))
    resume_err = float((resumed.flat["params"] - state.flat["params"]).abs().max())
    check(resume_err <= RESUME_PARAM_TOL,
          "resumed weights off the uninterrupted run's by %g" % resume_err)
    del resumer, resumed

    # The strategy's engine serves the trained weights (stale-weights check).
    val_pool = build_dataset(cfg, "val")
    val_pool.label_all()
    val_pool.resample_frames(TRAIN_BATCH)
    batch = next(iter(strategy._get_loader(val_pool, TRAIN_BATCH, 0)))
    images = strategy._device_images(batch)
    args = (strategy._put(batch["proj_matrices"]), strategy._put(batch["joint_valid"]),
            strategy._put(strategy.engine.pairs(VIEWS)), strategy._put(batch["3d_keypoints"]))
    strategy._load_state(state)

    def score(engine):
        out = engine.score_step(images, *args, int8_scales=engine.int8_calibrate(images))
        return torch.cat([out["keypoints_3d"].reshape(-1), out["al_metric"]])

    served = score(strategy.engine)
    fresh = Engine(cfg)
    fresh.load_state_dict(state.state_dict())
    trained = score(fresh)
    fresh.load_state_dict(init_weights)
    initial = score(fresh)
    del fresh
    stale_err = float((served - trained).abs().max() / trained.abs().max())
    init_gap = float((initial - trained).abs().max() / trained.abs().max())
    check(stale_err <= STALE_TOL, "the served scores are off the trained ones by %g" % stale_err)
    check(init_gap > 100 * STALE_TOL, "training did not change the scores (%g)" % init_gap)

    # (c) Steps on batches already on the card; eval and checkpoint times.
    train_pool = build_dataset(cfg, "train")
    train_pool.label_all()
    train_pool.resample_frames(-1, 0)
    loader = strategy._get_loader(train_pool, TRAIN_BATCH, 0)
    batches = []
    for b in loader:
        images_t, gt_t = strategy._device_batch(b, train=True)
        batches.append((images_t, gt_t, strategy._put(b["per_view_joint_valid"]),
                        strategy._put(b["frame_valid"])))
        if len(batches) == 4:
            break
    engine = strategy.engine
    bench_state = state.clone()
    it = [0]

    def step():
        nonlocal bench_state
        bench_state, metrics = engine.train_step(bench_state, *batches[it[0] % len(batches)])
        it[0] += 1
        return metrics

    torch.cuda.reset_peak_memory_stats()
    step_ms, _ = _timed_steps(step, 2, 10)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The deterministic flags' cost, in turns (on, off, off, on).
    flag_ms = {True: [], False: []}
    for on in (True, False, False, True):
        torch.backends.cudnn.deterministic = on
        flag_ms[on].append(_timed_steps(step, 2, 10)[0])
    use_deterministic_algorithms(dev)
    # The ops of a step that have no deterministic CUDA implementation.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    nondeterministic = sorted({str(w.message).split(" does not have")[0] for w in caught
                               if "deterministic" in str(w.message)})
    rcfg = cfg.clone()
    rcfg.TPU.REMAT = True
    remat = Engine(rcfg)
    a, b = state.clone(), state.clone()
    a, ma = engine.train_step(a, *batches[0])
    b, mb = remat.train_step(b, *batches[0])
    remat_loss_err = abs(float(ma["loss"]) - float(mb["loss"])) / abs(float(ma["loss"]))
    remat_bn_err = float((a.flat["buffers"] - b.flat["buffers"]).abs().max())
    check(remat_loss_err <= REMAT_LOSS_RTOL, "REMAT loss off by %g" % remat_loss_err)
    check(remat_bn_err <= REMAT_BN_TOL, "REMAT BN statistics off by %g" % remat_bn_err)
    del a, b
    bench_state = state.clone()
    engine = remat
    torch.cuda.reset_peak_memory_stats()
    remat_ms, _ = _timed_steps(step, 2, 5)
    remat_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del remat, bench_state, batches

    val_pool = build_dataset(cfg, "val")
    val_pool.label_all()
    val_pool.resample_frames(TRAIN_VAL_FRAMES)
    val_loader = strategy._get_loader(val_pool, TRAIN_BATCH)
    try:
        strategy._evaluate_all(-1, state, val_loader)  # warms the view cache
        t0 = time.perf_counter()
        strategy._evaluate_all(-1, state, val_loader)
        eval_s = time.perf_counter() - t0
    finally:
        val_loader.close()
    t0 = time.perf_counter()
    ckpt.save_checkpoints([os.path.join(tmp, "bench-CKPT"), os.path.join(tmp, "bench-FINAL")],
                          state, 1, TRAIN_LR)
    ckpt_save_s = time.perf_counter() - t0
    pipeline.shutdown_shared_executors()
    emit("train", model="PoseResNet-50", dtype=cfg.TPU.COMPUTE_DTYPE, batch=TRAIN_BATCH,
         views=VIEWS, img=IMG, joints=JOINTS, steps=TRAIN_STEPS, log_every=TRAIN_LOG_EVERY,
         val_frames=TRAIN_VAL_FRAMES, parity=parity, run_s=run_s, losses=losses.tolist(),
         mkpe=mkpe, checkpoints=names, launches=launches, synchronizing_calls=len(syncs),
         resume_param_max_err=resume_err, resume_param_tol=RESUME_PARAM_TOL,
         stale_rel_err=stale_err, initial_weights_rel_gap=init_gap,
         replay_bit_equal=True, deterministic_step_ms=flag_ms[True],
         default_step_ms=flag_ms[False], nondeterministic_ops=nondeterministic,
         step_ms=step_ms, frames_per_s=TRAIN_BATCH / step_ms * 1e3,
         crops_per_s=TRAIN_BATCH * VIEWS / step_ms * 1e3, peak_gib=peak_gib,
         remat_step_ms=remat_ms, remat_peak_gib=remat_peak_gib,
         remat_loss_rel_err=remat_loss_err, remat_bn_max_err=remat_bn_err,
         eval_s=eval_s, ckpt_save_s=ckpt_save_s, seconds=time.perf_counter() - t_phase)
    return launches


# The CLI (phase_workflow): the user's experiments/sample-config.yaml on the
# pool sweep's tree (synthetic Panoptic: 31 cameras, 19 joints, 256^2
# crops), cut in depth only (PERF.md section 4); crops, views, joints and
# model width stay.
WORKFLOW_CUTS = dict(AL__ITERATIONS=2, AL__INITIAL_AMOUNT=8, AL__ITER_AMOUNT=8,
                     SAL__NUM_FRAMES=[0, 4], TRAIN__OPTIM__TOTAL_STEPS=10,
                     TRAIN__LOG_EVERY_ITER=5)
WF_AL, WF_SAL, WF_STEPS = 8, 4, 10
# RandAugment on the card against the CPU, one [62, 256, 256, 3] batch:
# samples whose steps are all integer LUT / threshold ops must be equal;
# the others (blends, rotation) within 1e-3 on [0, 255]; heatmaps 1e-5.
AUG_NUM, AUG_MAGNITUDE = 2, 9
AUG_EXACT_OPS = ("equalize", "invert", "posterize", "solarize")
AUG_IMG_TOL, AUG_HEAT_TOL = 1e-3, 1e-5


def _workflow_yaml(tmp, name, tree, base=None, **options):
    """A config file for the CLI: `base` (a YAML under experiments/, else the
    defaults) on the synthetic tree, with `options` ({"NODE__KEY": value});
    (path, config, log dir)."""
    from multi_view_active_learning_tpu_torch.config import get_default_configs

    cfg = get_default_configs()
    if base:
        cfg.merge_from_file(os.path.join(REPO, base))
    log_dir = os.path.join(tmp, "workflow", name)
    _set_options(cfg, dict(dict(DATA__TYPE="synthetic", DATA__SYNTHETIC_ROOT=tree,
                                DATA__NUM_JOINTS=JOINTS, LOG_DIR=log_dir,
                                RESULTS=os.path.join(log_dir, "results.json")), **options))
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    return path, cfg, log_dir


class _WorkflowSpy:
    """Counts, over a CLI run, the batches every FrameLoader yields and the
    train steps (a train batch feeds a step; every other batch is a scoring
    or evaluation batch, one K1 launch each), and times each AL iteration's
    scoring sweep, training (with its evaluations) and evaluations, and the
    final AL_EVAL / EVAL, on the host clock with the card synchronized.
    With `time_steps`, each train step too (synchronized before and after:
    `step_ms`)."""

    def __init__(self, time_steps=False):
        import torch
        from multi_view_active_learning_tpu_torch import engine as engine_mod
        from multi_view_active_learning_tpu_torch import strategy as strategy_mod

        self.batches, self.train_steps, self.seconds = 0, 0, {}
        self.step_ms = [] if time_steps else None
        self._restore = []
        spy = self
        loader_cls = strategy_mod.FrameLoader

        class CountingLoader(loader_cls):
            def __iter__(self):
                for batch in loader_cls.__iter__(self):
                    spy.batches += 1
                    yield batch

        def patch(owner, name, value):
            self._restore.append((owner, name, getattr(owner, name)))
            setattr(owner, name, value)

        def timed(name, label):
            fn = getattr(strategy_mod.ActiveLearningStrategy, name)

            def wrapper(strategy, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(strategy, *args, **kwargs)
                finally:
                    torch.cuda.synchronize()
                    key = "%s/%s" % (label(strategy), name.strip("_"))
                    spy.seconds[key] = spy.seconds.get(key, 0.0) + time.perf_counter() - t0

            patch(strategy_mod.ActiveLearningStrategy, name, wrapper)

        train_step = engine_mod.Engine.train_step

        def counted_step(engine, *args, **kwargs):
            spy.train_steps += 1
            if spy.step_ms is None:
                return train_step(engine, *args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = train_step(engine, *args, **kwargs)
            torch.cuda.synchronize()
            spy.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        patch(strategy_mod, "FrameLoader", CountingLoader)
        patch(engine_mod.Engine, "train_step", counted_step)
        def stage(s):
            if s.al_cfg.EXPR_TYPE in ("AL", "SAL"):
                return "iteration %d" % s.al_cfg.AL.CURRENT_ITER
            return "experiment"

        for name in ("_compute_sal_dict", "_train", "_evaluate_all", "run_al_eval", "run_eval",
                     "cluster"):
            timed(name, stage)

    def remove(self):
        for owner, name, value in reversed(self._restore):
            setattr(owner, name, value)


def _run_cli(path):
    """workflow.main on `path` on the card (no --device), its printed
    summary kept off this script's output; (output, seconds)."""
    import contextlib
    import io

    import torch
    from multi_view_active_learning_tpu_torch import workflow

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = workflow.main(["--config_file", path])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _expr_dir(log_dir):
    names = [n for n in os.listdir(log_dir) if os.path.isdir(os.path.join(log_dir, n))]
    check(len(names) == 1, "experiment directories %s" % names)
    return os.path.join(log_dir, names[0])


def _check_results(log_dir, sizes, tag):
    with open(os.path.join(log_dir, "results.json")) as f:
        results = json.load(f)
    check(sorted(int(s) for s in results) == sorted(sizes), "%s RESULTS sizes %s" % (tag, list(results)))
    for size, r in results.items():
        values = [r["mkpe"]] + list(r["pcks"]) + list(r["pckh_pcks"])
        check(all(np.isfinite(values)), "%s RESULTS[%s] not finite: %s" % (tag, size, r))
    return {size: r["mkpe"] for size, r in results.items()}


def _timed_train_steps(strategy, state, train, steps=10):
    """ms a train step on four batches already on the card (each finished by
    `train(batch)`), its frames/s and crops/s, and the peak memory."""
    import torch

    from multi_view_active_learning_tpu_torch.data import build_dataset

    pool = build_dataset(strategy.al_cfg, "train")
    pool.label_all()
    pool.resample_frames(-1, 0)
    batches = []
    for b in strategy._get_loader(pool, TRAIN_BATCH, 0):
        batches.append(b)
        if len(batches) == 4:
            break
    engine, it = strategy.engine, [0]

    def step():
        nonlocal state
        b = batches[it[0] % len(batches)]
        it[0] += 1
        images, gt = train(b)
        state, metrics = engine.train_step(state, images, gt,
                                           strategy._put(b["per_view_joint_valid"]),
                                           strategy._put(b["frame_valid"]))
        return metrics

    torch.cuda.reset_peak_memory_stats()
    ms, metrics = _timed_steps(step, 2, steps)
    check(bool(torch.isfinite(metrics["loss"])), "timed train step loss %s" % metrics["loss"])
    return dict(step_ms=ms, frames_per_s=TRAIN_BATCH / ms * 1e3,
                crops_per_s=TRAIN_BATCH * VIEWS / ms * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30), batches


def _aug_card_against_cpu(strategy, batch, dev):
    """One augmented [62, 256, 256, 3] batch from a fixed key on the card and
    on the CPU, through the same functions: op draws identical, images and
    heatmaps within AUG_*_TOL (exact for samples of LUT ops only)."""
    import torch
    from multi_view_active_learning_tpu_torch.data import augmentation
    from multi_view_active_learning_tpu_torch.ops.heatmap import render_gaussian_heatmaps
    from multi_view_active_learning_tpu_torch.utils import prng

    images = torch.from_numpy(np.asarray(batch["images"])).reshape(-1, IMG, IMG, 3).float()
    kp = torch.from_numpy(np.asarray(batch["2d_keypoints"], np.float32)).reshape(-1, JOINTS, 2)
    heat = render_gaussian_heatmaps(kp / 4, IMG // 4, IMG // 4, 2.0)  # [62, 19, 64, 64]
    key = prng.PRNGKey(1307)
    opts = (AUG_NUM, AUG_MAGNITUDE, True, True, False)
    draws = {name: augmentation.draw_ops(key, images.shape[0], *opts) for name in ("cpu", "card")}
    check(all(np.array_equal(draws["cpu"][k], draws["card"][k]) for k in draws["cpu"]),
          "RandAugment draws differ between two calls")
    t0 = time.perf_counter()
    cpu_img, cpu_heat = augmentation.apply_ops(draws["cpu"], images, heat)
    cpu_s = time.perf_counter() - t0
    card_in = (images.to(dev), heat.to(dev))
    card_ms, (card_img, card_heat) = _timed_steps(
        lambda: augmentation.apply_ops(draws["card"], *card_in), 1, 5)
    img_err = (card_img.cpu() - cpu_img).abs().amax(dim=(1, 2, 3)).numpy()
    heat_err = float((card_heat.cpu() - cpu_heat).abs().max())
    exact = np.array([all(augmentation.OPS[o] in AUG_EXACT_OPS for o in row)
                      for row in draws["cpu"]["op"]])
    check(not img_err[exact].any(), "LUT-only samples differ: %s" % img_err[exact])
    check(float(img_err.max()) <= AUG_IMG_TOL, "augmented images off by %g" % img_err.max())
    check(heat_err <= AUG_HEAT_TOL, "augmented heatmaps off by %g" % heat_err)
    check(not torch.equal(cpu_img, images), "the batch was not augmented")
    used = sorted({augmentation.OPS[o] for o in draws["cpu"]["op"].reshape(-1)})
    return dict(shape=list(images.shape), ops_drawn=used, lut_only_samples=int(exact.sum()),
                img_max_abs_err=float(img_err.max()), heat_max_abs_err=heat_err,
                card_ms=card_ms, cpu_s=cpu_s)


def phase_workflow(dev, tree, tmp):
    """The port's CLI, `workflow.main` on the card, on the pool sweep's tree.
    (a) experiments/sample-config.yaml (HRNet-W32 bf16, SAL with
    TRIANGULATION, SAL.INLIER_THRESHOLD 7) cut in depth: SAMPLED-GUID-ITER-0
    and -1 hold 8 guids each without overlap, SAL-GUID-ITER-1 at most 4, the
    AL writer holds iteration 1's sal/* records, AL_EVAL's RESULTS sizes
    [8, 16] with finite MKPE / PCK / PCKh, K1 launched once per scoring and
    evaluation batch (counted from the loaders), and a warm sweep of
    iteration 1 with no synchronizing call; then HRNet-W32's bf16 train step.
    (b) PoseResNet-50 in the default configuration, SUPERVISED (then EVAL)
    with DATA.NUM_AUG 2, AUG_MAGNITUDE 9 and random magnitudes: finite losses
    and RESULTS; CLUSTER with POSE and LOSS holds every train guid; one
    augmented batch on the card against the CPU; the augmented train step
    beside the plain one.  (c) AL.STRATEGY=CORESET at (a)'s depth on
    PoseResNet-50 bf16: K2 launched once, in iteration 1."""
    import torch
    from multi_view_active_learning_tpu_torch import kernels
    from multi_view_active_learning_tpu_torch.data import build_dataset, pipeline
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy
    from multi_view_active_learning_tpu_torch.utils import checkpoint as ckpt
    from multi_view_active_learning_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    runs, launches = {}, {}
    try:
        # (a) The user's configuration.
        path, cfg, log_dir = _workflow_yaml(tmp, "sal-hrnet", tree, "experiments/sample-config.yaml",
                                            **WORKFLOW_CUTS)
        check(cfg.POSE_ESTIMATOR.TYPE == "HRNET" and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
              and cfg.EXPR_TYPE == "SAL" and cfg.SAL.INLIER_THRESHOLD == 7,
              "sample-config.yaml is not the HRNet SAL experiment")
        spy = _WorkflowSpy()
        kernels.reset_launch_counts()
        try:
            out, seconds = _run_cli(path)
        finally:
            spy.remove()
        launches["sal"] = kernels.launch_counts()
        k1_batches = spy.batches - spy.train_steps
        check(launches["sal"]["fused_decode"] == k1_batches,
              "K1 launched %d times for %d scoring and evaluation batches"
              % (launches["sal"]["fused_decode"], k1_batches))
        check(spy.train_steps == 2 * WF_STEPS, "%d train steps" % spy.train_steps)
        expr = _expr_dir(log_dir)
        logs = {}
        for name in ("SAMPLED-GUID-ITER-0", "SAMPLED-GUID-ITER-1", "SAL-GUID-ITER-1"):
            p = os.path.join(expr, name)
            logs[name] = json.load(open(p)) if os.path.exists(p) else []
        s0, s1 = logs["SAMPLED-GUID-ITER-0"], logs["SAMPLED-GUID-ITER-1"]
        check(len(s0) == WF_AL and len(s1) == WF_AL and not set(s0) & set(s1),
              "SAMPLED-GUID-ITER-0/1: %d and %d guids, %d shared"
              % (len(s0), len(s1), len(set(s0) & set(s1))))
        check(len(logs["SAL-GUID-ITER-1"]) <= WF_SAL, "SAL-GUID-ITER-1 %s" % logs["SAL-GUID-ITER-1"])
        with open(os.path.join(expr, "AL", "metrics.jsonl")) as f:
            al_tags = {(r["tag"], r["step"]) for r in map(json.loads, f)}
        for tag in ("sal/al_metric", "sal/al_num_frames", "sal/sal_num_frames",
                    "perf/scoring_frames_per_sec"):
            check((tag, 1) in al_tags, "the AL writer lacks %s at iteration 1" % tag)
        mkpe = _check_results(log_dir, [WF_AL, 2 * WF_AL], "SAL")
        check(out is not None and out.sizes == [WF_AL, 2 * WF_AL], "FlowOutput %s" % (out,))

        # A warm sweep of iteration 1 (its scorer, its pool) with no
        # synchronizing call; K1 once a batch.
        strategy = ActiveLearningStrategy(cfg.clone())
        strategy.al_cfg.EXPR_NAME = os.path.basename(expr)
        state = ckpt.restore_params_only(os.path.join(expr, "ITER-0", "checkpoints", "CKPT-FINAL"),
                                         strategy.new_state(salt=1))
        pool = strategy.restore_dataset(build_dataset(strategy.al_cfg, "train"), 1)
        pool.resample_unlabeled_data()
        cold_s, _ = _timed_sweep(strategy, pool, state)
        kernels.reset_launch_counts()
        warm_s, warm = _timed_sweep(strategy, pool, state)
        warm_k1 = kernels.launch_counts()["fused_decode"]
        spanned, records = _with_spans(lambda: strategy._compute_sal_dict(pool, state))
        syncs = _synced_spans(records)
        left = SWEEP_FRAMES - WF_AL
        _check_sweep(warm, left, "iteration 1 warm sweep")
        _sal_dict_err(spanned, warm, "iteration 1 warm sweep under the profiler against warm")
        check(not syncs, "warm sweep: %d synchronizing calls, in spans %s"
              % (len(syncs), sorted(set(syncs))))
        check(warm_k1 == -(-left // cfg.AL.INFERENCE.BATCH_SIZE), "warm sweep K1 %d" % warm_k1)
        hrnet_step, _ = _timed_train_steps(
            strategy, strategy.new_state(), lambda b: strategy._device_batch(b, train=True))
        del strategy, state
        runs["sal_hrnet"] = dict(
            seconds=seconds, per_iteration=dict(sorted(spy.seconds.items())),
            k1_launches=launches["sal"]["fused_decode"], k1_batches=k1_batches,
            loader_batches=spy.batches, train_steps=spy.train_steps,
            sampled=[len(s0), len(s1)], sal_guids=len(logs["SAL-GUID-ITER-1"]), mkpe=mkpe,
            warm_sweep=dict(cold_s=cold_s, warm_s=warm_s, frames=left, k1=warm_k1,
                            synchronizing_calls=len(syncs)),
            train_step=hrnet_step)
        shutil.rmtree(log_dir, ignore_errors=True)

        # (b) PoseResNet-50, the default configuration: SUPERVISED with
        # RandAugment, then CLUSTER.
        aug = dict(POSE_ESTIMATOR__NUM_LAYERS=DEPTH, DATA__NUM_AUG=AUG_NUM,
                   DATA__AUG_MAGNITUDE=AUG_MAGNITUDE, DATA__USE_CONST_AUG_MAGNITUDE=False,
                   TRAIN__OPTIM__TOTAL_STEPS=WF_STEPS, TRAIN__LOG_EVERY_ITER=WF_STEPS // 2)
        path, cfg, log_dir = _workflow_yaml(tmp, "supervised", tree, EXPR_TYPE="SUPERVISED", **aug)
        spy = _WorkflowSpy()
        try:
            out, seconds = _run_cli(path)
        finally:
            spy.remove()
        expr = _expr_dir(log_dir)
        with open(os.path.join(expr, "FULLY_SUPERVISED", "summary", "metrics.jsonl")) as f:
            losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "loss/train"]
        check(len(losses) == 2 and all(np.isfinite(losses)), "SUPERVISED losses %s" % losses)
        check(spy.train_steps == WF_STEPS, "SUPERVISED ran %d steps" % spy.train_steps)
        mkpe = _check_results(log_dir, [-1], "SUPERVISED")
        runs["supervised_aug"] = dict(seconds=seconds, losses=losses, mkpe=mkpe,
                                      per_stage=dict(sorted(spy.seconds.items())))
        shutil.rmtree(log_dir, ignore_errors=True)
        guids = set(build_dataset(cfg, "train").unlabeled_data)  # nothing labeled: every frame
        for kind in ("POSE", "LOSS"):
            path, _, log_dir = _workflow_yaml(tmp, "cluster-" + kind, tree, EXPR_TYPE="CLUSTER",
                                              AL__CLUSTER__TYPE=kind,
                                              AL__CLUSTER__SAVE_PATH=os.path.join(
                                                  tmp, "cluster-%s.json" % kind), **aug)
            out, seconds = _run_cli(path)
            with open(os.path.join(tmp, "cluster-%s.json" % kind)) as f:
                clusters = json.load(f)
            check(out is None and set(clusters) == guids,
                  "CLUSTER %s holds %d of %d train guids" % (kind, len(clusters), len(guids)))
            values = np.asarray(list(clusters.values()), np.float64)
            check(bool(np.isfinite(values).all()), "CLUSTER %s values not finite" % kind)
            runs["cluster_" + kind.lower()] = dict(seconds=seconds, frames=len(clusters))
            shutil.rmtree(log_dir, ignore_errors=True)

        # RandAugment on the card against the CPU, and the augmented step.
        strategy = ActiveLearningStrategy(cfg.clone())
        key = [prng.PRNGKey(7)]

        def finish(b):
            key[0], bkey = prng.split(key[0])
            return strategy._device_batch(b, train=True, key=bkey)

        strategy.al_cfg.DATA.NUM_AUG = 0
        plain_step, batches = _timed_train_steps(strategy, strategy.new_state(), finish)
        strategy.al_cfg.DATA.NUM_AUG = AUG_NUM
        aug_step, _ = _timed_train_steps(strategy, strategy.new_state(), finish)
        aug_check = _aug_card_against_cpu(strategy, batches[0], dev)
        del strategy
        runs["aug"] = dict(check=aug_check, plain_step=plain_step, augmented_step=aug_step,
                           model="PoseResNet-50", dtype=cfg.TPU.COMPUTE_DTYPE)

        # (c) CORESET at (a)'s depth, PoseResNet-50 bf16.
        path, cfg, log_dir = _workflow_yaml(
            tmp, "coreset", tree, "experiments/sample-config.yaml", POSE_ESTIMATOR__TYPE="POSE_RESNET",
            POSE_ESTIMATOR__NUM_LAYERS=DEPTH, AL__STRATEGY="CORESET", TPU__INT8_SCORING=False,
            **WORKFLOW_CUTS)
        spy = _WorkflowSpy()
        kernels.reset_launch_counts()
        try:
            out, seconds = _run_cli(path)
        finally:
            spy.remove()
        launches["coreset"] = kernels.launch_counts()
        check(launches["coreset"]["min_distance_to_centers"] == 1,
              "CORESET run: K2 launched %d times" % launches["coreset"]["min_distance_to_centers"])
        k1_batches = spy.batches - spy.train_steps
        check(launches["coreset"]["fused_decode"] == k1_batches,
              "CORESET run: K1 %d for %d batches" % (launches["coreset"]["fused_decode"], k1_batches))
        expr = _expr_dir(log_dir)
        s1 = json.load(open(os.path.join(expr, "SAMPLED-GUID-ITER-1")))
        check(len(s1) == WF_AL, "CORESET picked %d" % len(s1))
        mkpe = _check_results(log_dir, [WF_AL, 2 * WF_AL], "CORESET")
        runs["coreset"] = dict(seconds=seconds, per_iteration=dict(sorted(spy.seconds.items())),
                               launches=launches["coreset"], mkpe=mkpe)
        shutil.rmtree(log_dir, ignore_errors=True)
    finally:
        pipeline.shutdown_shared_executors()
    emit("workflow", model_a="HRNet-W32", model_bc="PoseResNet-50", frames=SWEEP_FRAMES,
         views=VIEWS, img=IMG, joints=JOINTS, cuts=WORKFLOW_CUTS, runs=runs,
         seconds=time.perf_counter() - t_phase)
    return {"fused_decode": launches["sal"]["fused_decode"],
            "min_distance_to_centers": launches["coreset"]["min_distance_to_centers"]}


# The CLI under more than one process (phase_distributed): run (c) of
# phase_workflow (SAL, CORESET, PoseResNet-50, the sample config's depth
# cuts) from one tree and seed, as "one" (1 process, no group, TRAIN and
# AL.INFERENCE batches of 4), "nccl1" (the same under a NCCL group of one,
# where every collective runs), "gloo2" (2 ranks sharing card 0 over gloo,
# batches of 2 a rank: the same global batches) and, with two cards or
# more, "nccl2" (2 ranks, a card each).
DIST_WORLD, DIST_BATCH = 2, 2
# In float32 (TF32 off) at an LR of 1e-9 (tools/dist_agreement_torch.py on
# the card: in bf16, the 62- and 124-crop batches' other cuDNN algorithms
# move the BN statistics by a bf16 rounding, enough to flip the argmax of
# a random-init heatmap, and at LR 1e-3 Adam turns a near-zero gradient's
# rounding into a full +-lr step, so the two runs' sal_dicts part by
# thousands of tolerances and no CORESET pick is decided by a gap above
# their difference; tests/test_torch_workflow.py takes 1e-9 for the same
# reason).  The BN statistics still fold at that LR, so the global
# statistics decide what the ranks score.
DIST_DTYPE, DIST_LR = "float32", 1e-9
# Bars of the ranks' run against the one-process run: sal_dict within the
# sweep tolerance (SAL_TOL, KP_*), inlier counts equal; the CORESET picks
# that greedy gaps above four times the feature rows' difference decide,
# equal and at least half of them; the log points' losses within rtol
# 1e-4; RESULTS' MKPE within 0.01 and PCK / PCKh within 0.01 (a joint of one
# of the 8 test frames moves them by 1/152).
DIST_LOSS_RTOL, DIST_MKPE_ATOL, DIST_PCK_ATOL = 1e-4, 1e-2, 1e-2


def _dist_yaml(tmp, name, tree, batch, dtype, lr, view_axis=1):
    return _workflow_yaml(
        tmp, name, tree, "experiments/sample-config.yaml", POSE_ESTIMATOR__TYPE="POSE_RESNET",
        POSE_ESTIMATOR__NUM_LAYERS=DEPTH, AL__STRATEGY="CORESET", TPU__INT8_SCORING=False,
        TPU__COMPUTE_DTYPE=dtype, TRAIN__BATCH_SIZE=batch, AL__INFERENCE__BATCH_SIZE=batch,
        TRAIN__OPTIM__LR=lr, TPU__VIEW_AXIS=view_axis, **WORKFLOW_CUTS)


def cli_rank(spec_path, rank):
    """One process of a `phase_distributed` run (``chip_smoke.py --cli-rank
    SPEC RANK``, started by `_run_ranks` with torchrun's environment): joins
    the group the spec names, runs the CLI on the card with the launch
    counters set to 0 just before it, and reports its launches (and the rows
    of each K1 launch), loader batches, train-step ms, per-stage seconds, the
    files it opened for writing under the run's LOG_DIR, each AL iteration's
    trained state (what that iteration's CKPT-FINAL holds) and the CORESET
    step's features."""
    import builtins

    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Runs that must repeat bit for bit: cuDNN's nondeterministic backward
    # algorithms (atomics) are out; cuBLAS is fixed by the environment
    # (CUBLAS_WORKSPACE_CONFIG, set by _run_ranks).
    torch.backends.cudnn.deterministic = True
    from multi_view_active_learning_tpu_torch import kernels, parallel
    from multi_view_active_learning_tpu_torch import strategy as strategy_mod
    from multi_view_active_learning_tpu_torch.kernels import decode

    with open(spec_path) as f:
        spec = json.load(f)
    if spec["backend"]:
        check(parallel.initialize_distributed(backend=spec["backend"]), "no process group")
        check(parallel.process_index() == rank, "rank %d" % parallel.process_index())
    writes, real_open = [], builtins.open

    def recording_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and isinstance(file, (str, bytes, os.PathLike)):
            writes.append(os.path.abspath(os.fsdecode(file)))
        return real_open(file, mode, *args, **kwargs)

    states, train = [], strategy_mod.ActiveLearningStrategy._train

    def keep_state(strategy, *args, **kwargs):
        state = train(strategy, *args, **kwargs)
        states.append({k: v.detach().cpu().clone() for k, v in state.flat.items()})
        return state

    k1_rows, launch = [], decode.launch

    def counting_launch(heatmaps_flat, *args):
        k1_rows.append(int(heatmaps_flat.shape[0]))
        return launch(heatmaps_flat, *args)

    spy = _WorkflowSpy(time_steps=True)
    coresets = _CoreSetSpy(strategy_mod.coreset_ops)
    strategy_mod.ActiveLearningStrategy._train = keep_state
    strategy_mod.coreset_ops = coresets
    builtins.open = recording_open
    decode.launch = counting_launch
    try:
        kernels.reset_launch_counts()
        out, seconds = _run_cli(spec["config"])
        launches = kernels.launch_counts()
    finally:
        decode.launch = launch
        builtins.open = real_open
        strategy_mod.coreset_ops = coresets.ops
        strategy_mod.ActiveLearningStrategy._train = train
        spy.remove()
    cs = coresets.built[-1]
    torch.save({"states": states, "features": np.asarray(cs.features), "n_sal": cs.n_sal,
                "keys": list(cs.sal_keys)}, os.path.join(spec["report_dir"], "rank%d.pt" % rank))
    with open(os.path.join(spec["report_dir"], "rank%d.json" % rank), "w") as f:
        json.dump(dict(rank=rank, world=parallel.process_count(), card=torch.cuda.current_device(),
                       mesh=list(parallel.current_mesh()), k1_rows=sorted(set(k1_rows)),
                       launches=launches, loader_batches=spy.batches, train_steps=spy.train_steps,
                       step_ms=spy.step_ms, seconds=dict(sorted(spy.seconds.items())), run_s=seconds,
                       writes=sorted({w for w in writes if w.startswith(spec["log_dir"])}),
                       expr_name=out.expr_name, coresets=len(coresets.built)), f)
    parallel.shutdown()
    left = stop_child_processes()
    check(not left, "rank %d left processes running: %s" % (rank, left))
    return 0


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(tmp, name, tree, world, batch, dtype, lr, backend, cards, view_axis=1):
    """The `world` processes of one run (a mesh of world / view_axis data
    rows), started together with torchrun's environment (none without a
    backend), on `cards`; any failure fails the phase.  Returns {"reports",
    "saved" (per rank), "log_dir", "wall_s"}."""
    import torch

    path, _, log_dir = _dist_yaml(tmp, name, tree, batch, dtype, lr, view_axis)
    report_dir = os.path.join(tmp, "reports", name)
    os.makedirs(report_dir, exist_ok=True)
    spec = os.path.join(report_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(config=path, backend=backend, log_dir=log_dir, report_dir=report_dir), f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for rank in range(world):
        rank_env = dict(env)
        if backend:
            rank_env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(cards[rank]),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cli-rank", spec, str(rank)],
            env=rank_env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.perf_counter() - t0
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0,
              "%s: rank %d exited %s:\n%s" % (name, rank, proc.returncode, out[-6000:]))
    reports, saved = [], []
    for rank in range(world):
        with open(os.path.join(report_dir, "rank%d.json" % rank)) as f:
            reports.append(json.load(f))
        saved.append(torch.load(os.path.join(report_dir, "rank%d.pt" % rank), weights_only=False))
    return dict(reports=reports, saved=saved, log_dir=log_dir, wall_s=wall_s)


def _run_files(run):
    """(guid logs and SAL-DICT as {name: bytes}, RESULTS) of a run."""
    expr = _expr_dir(run["log_dir"])
    logs = {}
    for name in sorted(os.listdir(expr)):
        if "GUID" in name or name.startswith("SAL-DICT"):
            with open(os.path.join(expr, name), "rb") as f:
                logs[name] = f.read()
    with open(os.path.join(run["log_dir"], "results.json")) as f:
        return logs, json.load(f)


def _state_diff(a, b):
    """The largest difference between two lists of flat-buffer dicts (0.0:
    bit for bit; inf when their layouts differ)."""
    if len(a) != len(b) or any(set(x) != set(y) for x, y in zip(a, b)):
        return float("inf")
    return max((float((x[k].double() - y[k].double()).abs().max()) if x[k].numel() else 0.0)
               for x, y in zip(a, b) for k in x)


def _check_ranks(run, name, k1_rows=None):
    """Each rank launched K1 once a scoring or evaluation batch of its own
    (its loaders' batches less its train steps; with `k1_rows`, every launch
    on that many heatmap rows, its own views') and K2 once (iteration 1's
    CORESET step), ran every train step, used one stamp, and holds rank 0's
    trained states bit for bit; rank 0 wrote the checkpoints and logs, the
    others RESULTS only (every rank writes it, as the JAX package does)."""
    reports, saved = run["reports"], run["saved"]
    for r in reports:
        if k1_rows is not None:
            check(r["k1_rows"] == [k1_rows], "%s rank %d: K1 on %s rows, not %d"
                  % (name, r["rank"], r["k1_rows"], k1_rows))
        k1 = r["loader_batches"] - r["train_steps"]
        check(r["launches"]["fused_decode"] == k1, "%s rank %d: K1 %d for %d batches"
              % (name, r["rank"], r["launches"]["fused_decode"], k1))
        check(r["launches"]["min_distance_to_centers"] == 1 and r["coresets"] == 1,
              "%s rank %d: K2 %d" % (name, r["rank"], r["launches"]["min_distance_to_centers"]))
        check(r["train_steps"] == 2 * WF_STEPS, "%s rank %d: %d steps" % (name, r["rank"],
                                                                        r["train_steps"]))
        check(r["world"] == len(reports), "%s: world %d" % (name, r["world"]))
        check(r["expr_name"] == reports[0]["expr_name"], "%s: stamps differ" % name)
        diff = _state_diff(saved[r["rank"]]["states"], saved[0]["states"])
        check(diff == 0.0, "%s: rank %d's trained states differ from rank 0's by %g"
              % (name, r["rank"], diff))
    check(os.path.basename(_expr_dir(run["log_dir"])) == reports[0]["expr_name"],
          "%s: experiment directory" % name)
    written = reports[0]["writes"]
    for what in ("ITER-0/checkpoints/CKPT-FINAL", "ITER-1/checkpoints/CKPT-FINAL",
                 "SAMPLED-GUID-ITER-1", "SAL-DICT-ITER-1"):
        check(any(what in w for w in written), "%s: rank 0 did not write %s" % (name, what))
    results = os.path.join(run["log_dir"], "results.json")
    for r in reports[1:]:
        check(set(r["writes"]) <= {results}, "%s: rank %d wrote %s" % (name, r["rank"], r["writes"]))


def _run_agreement(ref, got):
    """How the ranks' run `got` agrees with the one-process run `ref` (the
    same global batches): the sal_dict's worst share of the sweep tolerance
    (SAL_TOL, KP_*), inlier counts that differ, the largest CORESET
    feature-row difference, the picks covered (each decided by a greedy gap
    above four times that difference) and whether those are equal, the
    iteration-0 draw, the pseudo-labels, and RESULTS side by side."""
    (ref_logs, ref_res), (got_logs, got_res) = _run_files(ref), _run_files(got)
    ref_sal, sal = (json.loads(x["SAL-DICT-ITER-1"]) for x in (ref_logs, got_logs))
    worst, inliers = 0.0, 0
    for guid in ref_sal["al_metric"]:
        inliers += sal["inlier_count"][guid] != ref_sal["inlier_count"][guid]
        for metric in ("sal_metric", "mkpe"):
            a, b = sal[metric][guid], ref_sal[metric][guid]
            worst = max(worst, abs(a - b) / (SAL_TOL + SAL_TOL * abs(b)))
        a, b = (np.asarray(x["pred_3d_keypoints"][guid]) for x in (sal, ref_sal))
        worst = max(worst, float(np.max(np.abs(a - b) / (KP_ATOL + KP_RTOL * np.abs(b)))))
    rcs, gcs = ref["saved"][0], got["saved"][0]
    n_sal = rcs["n_sal"]
    order = [gcs["keys"].index(k) for k in rcs["keys"]]
    feats = np.concatenate([gcs["features"][:n_sal][order], gcs["features"][n_sal:]])
    row_err = float(np.linalg.norm(feats.astype(np.float64) - rcs["features"], axis=-1).max())
    ref_picks, picks = (json.loads(x["SAMPLED-GUID-ITER-1"]) for x in (ref_logs, got_logs))
    gaps = _greedy_gaps(rcs["features"], n_sal, len(ref_picks))
    covered = next((i for i, g in enumerate(gaps) if g <= 4 * row_err), len(gaps))
    pseudo = [json.loads(x.get("SAL-GUID-ITER-1", b"[]")) for x in (ref_logs, got_logs)]
    losses = []
    for run in (got, ref):
        expr = _expr_dir(run["log_dir"])
        records = []
        for it in ("ITER-0", "ITER-1"):
            with open(os.path.join(expr, it, "summary", "metrics.jsonl")) as f:
                records += [r["value"] for r in map(json.loads, f) if r["tag"] == "loss/train"]
        losses.append(records)
    return dict(
        train_losses=losses,
        sal_dict_worst_share=worst, inlier_counts_differ=int(inliers), feature_row_err=row_err,
        greedy_gaps=gaps, picks=len(ref_picks), picks_covered=covered,
        covered_picks_equal=picks[:covered] == ref_picks[:covered],
        picks_byte_equal=got_logs["SAMPLED-GUID-ITER-1"] == ref_logs["SAMPLED-GUID-ITER-1"],
        iteration0_byte_equal=got_logs["SAMPLED-GUID-ITER-0"] == ref_logs["SAMPLED-GUID-ITER-0"],
        pseudo_labels=[len(p) for p in pseudo], pseudo_labels_equal=pseudo[0] == pseudo[1],
        results={size: dict(mkpe=[got_res[size]["mkpe"], r["mkpe"]],
                            pck_max_diff=float(np.max(np.abs(np.subtract(got_res[size]["pcks"],
                                                                         r["pcks"])))),
                            pckh_max_diff=float(np.max(np.abs(np.subtract(
                                got_res[size]["pckh_pcks"], r["pckh_pcks"])))))
                 for size, r in ref_res.items()})


def _check_agreement(name, a):
    """The DIST_* bars of a ranks' run against the one-process run
    (`_run_agreement`'s `a`)."""
    check(a["iteration0_byte_equal"], "%s: SAMPLED-GUID-ITER-0 differs" % name)
    check(a["sal_dict_worst_share"] <= 1.0 and not a["inlier_counts_differ"],
          "%s: sal_dict off by %g of its tolerance, %d inlier counts differ"
          % (name, a["sal_dict_worst_share"], a["inlier_counts_differ"]))
    check(a["covered_picks_equal"] and a["picks_covered"] >= a["picks"] // 2,
          "%s: %d of %d picks decided by a gap above 4 x %g, equal: %s"
          % (name, a["picks_covered"], a["picks"], a["feature_row_err"],
             a["covered_picks_equal"]))
    check(a["pseudo_labels_equal"], "%s: SAL-GUID-ITER-1 differs" % name)
    got, ref = a["train_losses"]
    check(len(got) == len(ref) == 4 and np.allclose(got, ref, rtol=DIST_LOSS_RTOL, atol=0),
          "%s: log-point losses %s against %s" % (name, got, ref))
    for size, r in a["results"].items():
        check(abs(r["mkpe"][0] - r["mkpe"][1]) <= DIST_MKPE_ATOL
              and r["pck_max_diff"] <= DIST_PCK_ATOL and r["pckh_max_diff"] <= DIST_PCK_ATOL,
              "%s: RESULTS[%s] %s" % (name, size, r))


def _timing(run):
    """Each rank's median train-step ms and iteration-1 sweep seconds."""
    return [dict(step_ms=statistics.median(r["step_ms"]),
                 sweep_s=r["seconds"]["iteration 1/compute_sal_dict"], run_s=r["run_s"])
            for r in run["reports"]]


def distributed_runs(tree, tmp, dtype, lr):
    """The phase's runs and what they show, without the agreement bars:
    (runs, agreement of the ranks' runs with the one-process run)."""
    import torch

    runs = {"one": _run_ranks(tmp, "one", tree, 1, 2 * DIST_BATCH, dtype, lr, None, [0]),
            "nccl1": _run_ranks(tmp, "nccl1", tree, 1, 2 * DIST_BATCH, dtype, lr, "nccl", [0]),
            "gloo2": _run_ranks(tmp, "gloo2", tree, DIST_WORLD, DIST_BATCH, dtype, lr, "gloo",
                                [0] * DIST_WORLD)}
    if torch.cuda.device_count() >= DIST_WORLD:
        runs["nccl2"] = _run_ranks(tmp, "nccl2", tree, DIST_WORLD, DIST_BATCH, dtype, lr, "nccl",
                                   list(range(DIST_WORLD)))
    for name, run in runs.items():
        _check_ranks(run, name)
    (one_logs, one_res), (logs, res) = _run_files(runs["one"]), _run_files(runs["nccl1"])
    agreement = {name: _run_agreement(runs["one"], runs[name]) for name in runs
                 if name.endswith("2")}
    agreement["nccl1"] = dict(
        logs_differ=sorted(n for n in set(one_logs) | set(logs) if one_logs.get(n) != logs.get(n)),
        results_equal=one_res == res,
        state_diff=_state_diff(runs["one"]["saved"][0]["states"], runs["nccl1"]["saved"][0]["states"]))
    return runs, agreement


def phase_distributed(tree, tmp):
    """Data parallelism through the CLI (`distributed_runs`, DIST_DTYPE at
    DIST_LR): the NCCL group of one equals no group bit for bit (guid logs,
    SAL-DICT, RESULTS, both iterations' trained states); every ranks' run
    passes `_check_ranks` (K1 once a batch of its own, K2 once, bit-equal
    states, rank 1 writes RESULTS only) and agrees with the one-process
    run at twice the batch within the DIST_* bars.  Prints each rank's
    median train-step ms and iteration-1 sweep seconds beside the
    one-process run's (ranks that share one card share its SMs: these are
    not scaling figures).  Returns K1's and K2's launches by run."""
    import torch

    t_phase = time.perf_counter()
    runs, agreement = distributed_runs(tree, os.path.join(tmp, "distributed"), DIST_DTYPE,
                                       DIST_LR)
    same = agreement["nccl1"]
    check(not same["logs_differ"] and same["results_equal"] and same["state_diff"] == 0.0,
          "the NCCL world of one differs from the run without a group: %s" % same)
    for name, a in agreement.items():
        if name != "nccl1":
            _check_agreement(name, a)
    timing = {name: _timing(run) for name, run in runs.items()}
    emit("distributed", dtype=DIST_DTYPE, lr=DIST_LR, world=DIST_WORLD, batch_a_rank=DIST_BATCH,
         cards=torch.cuda.device_count(), runs=sorted(runs), agreement=agreement, timing=timing,
         wall_s={name: run["wall_s"] for name, run in runs.items()},
         seconds=time.perf_counter() - t_phase)
    return {kernel: {name: [r["launches"][kernel] for r in run["reports"]]
                     for name, run in runs.items()}
            for kernel in ("fused_decode", "min_distance_to_centers")}


# View sharding (phase_view_sharding): run (c) of phase_distributed on a
# synthetic Panoptic-schema tree of 16 cameras (InterHand2.6M's
# NUM_VIEW_PER_FRAME, which 2 divides; 31 does not, and its views would be
# replicated on the view axis), its other sizes the pool sweep's (64 + 8
# frames, 256^2, 19 joints): "one" (one process at batches of 4), "grid1x2"
# (a 1 x 2 data x view mesh of two gloo ranks sharing card 0, batches of 4
# a data row: the same global batches, each rank 8 views of every frame)
# and, with four cards, "grid2x2" (2 x 2 NCCL ranks, a card each, batches
# of 2 a data row), held to "one" at phase_distributed's bars.
VS_CAMERAS, VS_VIEW_AXIS, VS_BATCH = 16, 2, 4


def view_sharding_runs(tree, tmp, dtype=DIST_DTYPE, lr=DIST_LR):
    """The phase's runs, each rank checked by `_check_ranks` (K1 on its own
    views' rows, B x 16 / 2 x 19 a launch), and their agreement with the
    one-process run: (runs, agreement)."""
    import torch

    runs = {"one": _run_ranks(tmp, "one", tree, 1, VS_BATCH, dtype, lr, None, [0]),
            "grid1x2": _run_ranks(tmp, "grid1x2", tree, VS_VIEW_AXIS, VS_BATCH, dtype, lr, "gloo",
                                  [0] * VS_VIEW_AXIS, view_axis=VS_VIEW_AXIS)}
    if torch.cuda.device_count() >= 4:
        runs["grid2x2"] = _run_ranks(tmp, "grid2x2", tree, 4, VS_BATCH // 2, dtype, lr, "nccl",
                                     [0, 1, 2, 3], view_axis=VS_VIEW_AXIS)
    _check_ranks(runs["one"], "one", k1_rows=VS_BATCH * VS_CAMERAS * JOINTS)
    _check_ranks(runs["grid1x2"], "grid1x2",
                 k1_rows=VS_BATCH * VS_CAMERAS // VS_VIEW_AXIS * JOINTS)
    if "grid2x2" in runs:
        _check_ranks(runs["grid2x2"], "grid2x2",
                     k1_rows=VS_BATCH // 2 * VS_CAMERAS // VS_VIEW_AXIS * JOINTS)
    for name, run in runs.items():
        meshes = {tuple(r["mesh"]) for r in run["reports"]}
        want = {"one": (1, 1), "grid1x2": (1, 2), "grid2x2": (2, 2)}[name]
        check(meshes == {want}, "%s: meshes %s" % (name, meshes))
    agreement = {name: _run_agreement(runs["one"], run) for name, run in runs.items()
                 if name != "one"}
    return runs, agreement


def phase_view_sharding(tmp):
    """View sharding (TPU.VIEW_AXIS 2) through the CLI (`view_sharding_runs`,
    DIST_DTYPE at DIST_LR, cuDNN deterministic in each rank): every grid
    passes `_check_ranks` and phase_distributed's bars against the
    one-process run.  Prints each rank's median train-step ms and
    iteration-1 sweep seconds and the phase's seconds; ranks that share
    one card share its SMs, so they give no scaling figure.  Returns K1's
    and K2's launches by run."""
    import torch
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tree = generate_panoptic_tree(os.path.join(tmp, "views16"), num_train_frames=SWEEP_FRAMES,
                                  num_val_frames=TRAIN_VAL_FRAMES, num_joints=JOINTS,
                                  num_cameras=VS_CAMERAS)
    tree_s = time.perf_counter() - t0
    runs, agreement = view_sharding_runs(tree, os.path.join(tmp, "view_sharding"))
    for name, a in agreement.items():
        _check_agreement(name, a)
    emit("view_sharding", dtype=DIST_DTYPE, lr=DIST_LR, cameras=VS_CAMERAS,
         view_axis=VS_VIEW_AXIS, batch_a_data_row={name: VS_BATCH // (2 if name == "grid2x2" else 1)
                                                  for name in runs},
         cards=torch.cuda.device_count(), runs=sorted(runs), agreement=agreement,
         timing={name: _timing(run) for name, run in runs.items()},
         k1_rows={name: [r["k1_rows"] for r in run["reports"]] for name, run in runs.items()},
         scaling="none: grid1x2's two ranks share card 0's SMs",
         wall_s={name: run["wall_s"] for name, run in runs.items()}, tree_s=tree_s,
         seconds=time.perf_counter() - t_phase)
    return {kernel: {name: [r["launches"][kernel] for r in run["reports"]]
                     for name, run in runs.items()}
            for kernel in ("fused_decode", "min_distance_to_centers")}


# -- serving (phase_serving) and the learning tools (phase_learning) ---------

# The artifacts phase_serving exports at full width (PoseResNet-50 and
# HRNet-W32, 31 views, 256x256, K=19, bf16 compute, seeded weights): (name,
# model, TPU options, int8 (static scales), export batch (None: symbolic),
# batches each is called at in the fresh process).
SERVE_ARTIFACTS = [
    ("pose_resnet50_bf16_b4", "POSE_RESNET", {}, False, 4, (4,)),
    ("pose_resnet50_bf16_sym", "POSE_RESNET", {}, False, None, (1, 4)),
    ("hrnet_w32_bf16_b1", "HRNET", {}, False, 1, (1,)),
    ("pose_resnet50_int8_sym", "POSE_RESNET", {"INT8_SCORING": True}, True, None, (1, 4)),
    ("pose_resnet50_k3_b4", "POSE_RESNET", {"PALLAS_HEAD": True}, False, 4, (4,)),
    ("pose_resnet50_k4_b4", "POSE_RESNET", {"INT8_SCORING": True, "INT8_DECONV": True}, True, 4,
     (4,)),
]
# The head kernel an artifact's graph calls three times (once a deconv layer).
SERVE_HEADS = {"pose_resnet50_k3_b4": "fused_deconv_bn_relu",
               "pose_resnet50_k4_b4": "fused_deconv_bn_relu_int8"}
# bench_serving_torch on these artifacts (bf16 and int8, B=1 latency and
# B=1 / 4 throughput).
SERVE_BENCH = ("pose_resnet50_bf16_sym", "pose_resnet50_int8_sym")
SERVE_BENCH_ARGS = ["--requests", "50", "--batches", "1,4", "--warmup_s", "2"]
# An artifact against the eager serve function on the same inputs: the
# same aten ops on the same card, but in another process, where cuDNN may
# pick another bf16 algorithm; so the heatmaps within one bf16 step of
# their scale, the keypoints equal wherever the map's top two values lie
# more than twice that apart, the confidence within it.
SERVE_ATOL_OF_SCALE = 2.0**-7
# The bf16 main-path score_step before the kernels became registered
# operators, as PERF.md §5 records it (H100 80GB HBM3, 700 W).
PARENT_BF16_STEP_MS = 22.444
# validate_learning_torch's bar (tools/validate_learning.py:103-105).
LEARN_MKPE, LEARN_PCK5 = 3.0, 0.95
SERVE_BANNED = ("jax", "jaxlib", "flax", "optax", "multi_view_active_learning_tpu")
SERVE_PORT_BANNED = ("multi_view_active_learning_tpu_torch.engine",
                     "multi_view_active_learning_tpu_torch.models",
                     "multi_view_active_learning_tpu_torch.config")


def _serve_banned(name):
    return name.split(".")[0] in SERVE_BANNED or any(
        name == b or name.startswith(b + ".") for b in SERVE_PORT_BANNED)


class _RefuseServeImports:
    """An import hook: the fresh serving process may load torch and the
    port's kernel registrations and loader, nothing of JAX and not the
    port's engine, models or config."""

    def find_spec(self, name, path=None, target=None):
        if _serve_banned(name):
            raise ImportError("refused import: " + name)
        return None


def serve_load(spec_path):
    """The fresh process of phase_serving (``chip_smoke.py --serve-load
    SPEC``): loads each artifact, calls it at its batches on the card, and
    writes the outputs, each call's kernel launches, the load seconds and
    any refused module that was loaded."""
    sys.meta_path.insert(0, _RefuseServeImports())
    sys.path.insert(0, REPO)
    import torch
    from multi_view_active_learning_tpu_torch import kernels, serving

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    requests = np.load(spec["requests"])
    report = {}
    for name, a in spec["artifacts"].items():
        t0 = time.perf_counter()
        call = serving.load_serving(a["path"], device=dev)
        load_s = time.perf_counter() - t0
        launches = {}
        for b in a["calls"]:
            images = torch.from_numpy(requests["images%d" % b]).to(dev)
            box = torch.from_numpy(requests["box%d" % b]).to(dev)
            call(images, box)
            sync()
            kernels.reset_launch_counts()
            out = call(images, box)
            sync()
            launches[str(b)] = kernels.launch_counts()
            np.savez(os.path.join(spec["out"], "%s_b%d.npz" % (name, b)),
                     **{k: v.cpu().numpy() for k, v in out.items()})
        report[name] = dict(load_s=load_s, launches=launches, device=str(call.device))
    report["refused_loaded"] = sorted(m for m in sys.modules if _serve_banned(m))
    with open(spec["report"], "w") as f:
        json.dump(report, f)
    return 0


def _serve_requests(tmp):
    """uint8 requests at B=1 and 4 with non-square boxes, saved for the
    fresh process."""
    rng = np.random.default_rng(21)
    arrays = {}
    for b in (1, 4):
        arrays["images%d" % b] = rng.integers(0, 256, size=(b, VIEWS, IMG, IMG, 3)).astype(np.uint8)
        lt = rng.uniform(0, 200, size=(b, VIEWS, 2))
        wh = rng.uniform(300, 900, size=(b, VIEWS, 2))
        arrays["box%d" % b] = np.concatenate([lt, lt + wh], axis=-1).astype(np.float32)
    path = os.path.join(tmp, "serve_requests.npz")
    np.savez(path, **arrays)
    return path, arrays


def _serve_agreement(got, ref):
    """(heatmaps' max error over their scale, keypoints differing where the
    argmax is unique, maps with a unique argmax, confidence's max error
    over the heatmaps' scale) of an artifact's outputs against eager's."""
    scale = float(np.abs(ref["heatmaps"]).max())
    atol = SERVE_ATOL_OF_SCALE * scale
    heat_err = float(np.abs(got["heatmaps"] - ref["heatmaps"]).max()) / scale
    h = ref["heatmaps"]
    flat = np.moveaxis(h, -1, -3).reshape(h.shape[:-3] + (h.shape[-1], -1))
    top = np.sort(flat, axis=-1)[..., -2:]
    unique = top[..., 1] - top[..., 0] > 2 * atol
    kp_differ = int(np.sum(np.any(got["keypoints"] != ref["keypoints"], axis=-1) & unique))
    conf_err = float(np.abs(got["confidence"] - ref["confidence"]).max()) / scale
    return heat_err, kp_differ, float(unique.mean()), conf_err


def _tool_main(main, argv):
    """(exit code, stdout) of a tool's main(argv) run in this process; its
    stdout is echoed."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    print(text, end="", flush=True)
    return rc, text


def _tools():
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)


def phase_serving(dev, ctx, tmp):
    """Serving at full width (serving.py): each of SERVE_ARTIFACTS exported
    on the card (export seconds, MB), its graph calling the registered
    kernel operators (K1 once, the head kernel three times), then loaded and
    called in a fresh process (``--serve-load``) that refuses JAX and the
    port's engine, models and config; its outputs against the eager serve
    function's on the same inputs, and each call's launches from that
    process's counters.  Then tools/bench_serving_torch.py on the bf16 and
    int8 symbolic artifacts.  Returns the launches one serve call makes of
    each kernel on the artifacts that drive it."""
    import torch
    from multi_view_active_learning_tpu_torch import serving

    t_phase = time.perf_counter()
    serve_dir = os.path.join(tmp, "serving")
    os.makedirs(os.path.join(serve_dir, "out"))
    requests_path, requests = _serve_requests(serve_dir)
    artifacts, eager = {}, {}
    for name, model, tpu, int8, batch, calls in SERVE_ARTIFACTS:
        state_dict = ctx["state_dict"] if model == "POSE_RESNET" else hrnet_state_dict()
        engine = _engine("bfloat16", dev, state_dict, model=model, **tpu)
        engine.cfg.DATA.INPUT_HEIGHT = engine.cfg.DATA.INPUT_WIDTH = IMG  # the artifact's crops
        scales = engine.int8_calibrate(ctx["images"]) if int8 else None
        check((scales is not None) == int8, "%s: int8 calibration" % name)
        t0 = time.perf_counter()
        ep = serving.export_serving(engine, None, batch, VIEWS, int8_scales=scales)
        export_s = time.perf_counter() - t0
        path = serving.save_serving(ep, os.path.join(serve_dir, name + serving.SERVING_SUFFIX))
        ops = [str(n.target) for n in ep.graph.nodes if str(n.target).startswith("mval.")]
        want = ["mval.int8_conv_bn.default"] * 53 if int8 else []  # K5 a backbone conv
        want += ["mval.%s.default" % SERVE_HEADS[name]] * 3 if name in SERVE_HEADS else []
        check(ops == want + ["mval.fused_decode.default"], "%s: graph calls %s" % (name, ops))
        module = serving.build_serve_fn(engine, None, scales)
        eager[name] = {}
        with torch.inference_mode():
            for b in calls:
                out = module(torch.from_numpy(requests["images%d" % b]).to(dev),
                             torch.from_numpy(requests["box%d" % b]).to(dev))
                eager[name][b] = {k: v.cpu().numpy() for k, v in out.items()}
        artifacts[name] = dict(path=path, calls=list(calls), export_s=export_s,
                               mb=os.path.getsize(path) / 1e6, batch=batch or "b",
                               graph_ops=len(ops))
        del engine, module, ep
        torch.cuda.empty_cache()

    spec = dict(artifacts={n: dict(path=a["path"], calls=a["calls"]) for n, a in artifacts.items()},
                device=str(dev), requests=requests_path, out=os.path.join(serve_dir, "out"),
                report=os.path.join(serve_dir, "report.json"))
    spec_path = os.path.join(serve_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-load", spec_path],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, "the fresh serving process failed:\n%s" % proc.stderr[-6000:])
    fresh_s = time.perf_counter() - t0
    with open(spec["report"]) as f:
        report = json.load(f)
    check(not report["refused_loaded"], "the serving process loaded %s" % report["refused_loaded"])
    serving_launches = {}
    for name, a in artifacts.items():
        a["load_s"] = report[name]["load_s"]
        a["calls"] = {}
        for b in eager[name]:
            got = dict(np.load(os.path.join(spec["out"], "%s_b%d.npz" % (name, b))))
            ref = eager[name][b]
            shapes = {k: got[k].shape for k in got}
            check(shapes == {"heatmaps": (b, VIEWS, IMG // 4, IMG // 4, JOINTS),
                             "keypoints": (b, VIEWS, JOINTS, 2), "confidence": (b, VIEWS, JOINTS)}
                  and all(np.isfinite(v).all() for v in got.values()),
                  "%s at B=%d: outputs %s" % (name, b, shapes))
            heat_err, kp_differ, unique, conf_err = _serve_agreement(got, ref)
            check(heat_err <= SERVE_ATOL_OF_SCALE and kp_differ == 0
                  and conf_err <= SERVE_ATOL_OF_SCALE,
                  "%s at B=%d against eager: heatmaps %g of scale, %d unique-argmax keypoints "
                  "differ, confidence %g" % (name, b, heat_err, kp_differ, conf_err))
            launches = report[name]["launches"][str(b)]
            head = SERVE_HEADS.get(name)
            int8 = "int8" in name or "k4" in name
            for kernel, n in launches.items():
                want = (1 if kernel == "fused_decode" else 3 if kernel == head
                        else 53 if kernel == "int8_conv_bn" and int8 else 0)
                check(n == want, "%s at B=%d: %s launched %d times a call, want %d"
                      % (name, b, kernel, n, want))
                if n:
                    serving_launches[kernel] = n
            a["calls"][b] = dict(heat_err_of_scale=heat_err, unique_argmax_share=unique,
                                 keypoints_differ=kp_differ, confidence_err_of_scale=conf_err,
                                 launches=launches)
    emit("serving", views=VIEWS, img=IMG, joints=JOINTS, dtype="bfloat16", artifacts=artifacts,
         fresh_process_s=fresh_s, atol_of_scale=SERVE_ATOL_OF_SCALE)

    _tools()
    import bench_serving_torch

    bench = {}
    for name in SERVE_BENCH:
        rc, text = _tool_main(bench_serving_torch.main,
                              ["--artifact", artifacts[name]["path"]] + SERVE_BENCH_ARGS)
        check(rc == 0, "bench_serving_torch on %s: exit %d" % (name, rc))
        bench[name] = json.loads(text.strip().splitlines()[-1])
        check(bench[name]["device"] == torch.cuda.get_device_name(0), "%s: bench device" % name)
    emit("serving_bench", bench=bench, args=SERVE_BENCH_ARGS,
         seconds=time.perf_counter() - t_phase)
    for kernel in ("fused_decode", "fused_deconv_bn_relu", "fused_deconv_bn_relu_int8",
                   "int8_conv_bn"):
        check(serving_launches.get(kernel), "%s was not launched by a serve call" % kernel)
    serving_launches["min_distance_to_centers"] = 0
    return serving_launches


def _line(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def phase_learning(tmp):
    """The tools that prove the port learns, on the card: tools/
    validate_learning_torch.py at its defaults (PoseResNet-18, 64x64,
    float32, B=4, 2000 steps) with --int8_compare must print VALIDATION
    PASSED (train-set MKPE < 3.0, 3D-PCK@5 > 0.95); its train seconds, MKPE,
    PCK@5 and int8-compare rows are printed.  (tools/validate_al_gain_torch.py
    runs on the card through its own command: its --calibrate alone trains
    twice, which would take this script past half its time limit.)"""
    _tools()
    import validate_learning_torch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rc, text = _tool_main(validate_learning_torch.main,
                          ["--int8_compare", "--workdir", os.path.join(tmp, "validate")])
    validate_s = time.perf_counter() - t0
    check("VALIDATION PASSED" in text, "validate_learning_torch did not pass:\n%s" % text[-3000:])
    mkpe_line = _line(text, "train-set MKPE:")[0].split()
    train_line = _line(text, "train time:")[0].split()
    rows = [line for line in text.splitlines()
            if " vs float [" in line or "[CORESET]" in line or line.startswith(
                ("median per-frame", "eval MKPE", "GATE VIOLATION", "note:", "INT8 COMPARE"))]
    emit("learning", steps=2000, train_s=float(train_line[2].rstrip("s")),
         train_set_mkpe=float(mkpe_line[2]), pck5=float(mkpe_line[4]),
         bar=dict(mkpe=LEARN_MKPE, pck5=LEARN_PCK5), validation="PASSED", exit_code=rc,
         int8_compare=_line(text, "INT8 COMPARE")[0].split()[-1], int8_compare_rows=rows,
         tool_s=validate_s, seconds=time.perf_counter() - t_phase)


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
    rows = [phase_k1(dev, flush), phase_k2(dev, flush), phase_k3(dev, flush), phase_k4(dev, flush),
            phase_k5(dev, flush)]
    phase_model(dev)
    phase_hrnet_model(dev)
    cfg = get_default_configs()
    pairs = all_view_pairs(VIEWS, cfg.AL.RANSAC_N_ITERS, int(cfg.RANDOM_SEED) & 0x7FFFFFFF)
    phase_triangulation(dev, pairs)
    launches, ctx = phase_main_path(dev)
    path_launches = phase_paths(dev, ctx)
    phase_hrnet_path(dev, ctx)
    phase_embedding(dev, ctx)
    phase_reformulations(dev, ctx)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        serving_launches = phase_serving(dev, ctx, tmp)
        sweep_launches, golden, tree = phase_pool_sweep(dev, ctx, tmp)
        train_launches = phase_train(dev, tree, tmp)
        workflow_launches = phase_workflow(dev, tree, tmp)
        distributed_launches = phase_distributed(tree, tmp)
        view_launches = phase_view_sharding(tmp)
        phase_learning(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # Each kernel's launches on the path that drives it.
    launches["fused_deconv_bn_relu"] = path_launches["bf16_k3"]["fused_deconv_bn_relu"]
    launches["fused_deconv_bn_relu_int8"] = path_launches["int8_k4"]["fused_deconv_bn_relu_int8"]
    launches["int8_conv_bn"] = path_launches["int8"]["int8_conv_bn"]
    for row in rows:
        row["launches"] = launches[row["name"]]
    # K1 and K5 in a warm sweep of the default configuration, K2 in a CORESET step.
    rows[0]["sweep_launches"] = sweep_launches["int8"]["fused_decode"]
    rows[4]["sweep_launches"] = sweep_launches["int8"]["int8_conv_bn"]
    rows[1]["sweep_launches"] = sweep_launches["coreset"]["min_distance_to_centers"]
    # K1 in the full-width training run (its evaluations).
    rows[0]["train_launches"] = train_launches["fused_decode"]
    # K1 in the CLI's HRNet SAL run (a), K2 in its CORESET run (c).
    rows[0]["workflow_launches"] = workflow_launches["fused_decode"]
    rows[1]["workflow_launches"] = workflow_launches["min_distance_to_centers"]
    # K1 and K2 on each rank of phase_distributed's runs (run -> per rank).
    rows[0]["distributed_launches"] = distributed_launches["fused_decode"]
    rows[1]["distributed_launches"] = distributed_launches["min_distance_to_centers"]
    # K1 and K2 on each rank of phase_view_sharding's runs (K1 on the rank's views).
    rows[0]["view_sharding_launches"] = view_launches["fused_decode"]
    rows[1]["view_sharding_launches"] = view_launches["min_distance_to_centers"]
    # Each kernel's launches in one serve call of the artifact that drives it.
    for row in rows:
        row["serving_launches"] = serving_launches[row["name"]]
    return smi, rows, time.perf_counter() - t0


KERNEL_PHASES = {"k1": phase_k1, "k2": phase_k2, "k3": phase_k3, "k4": phase_k4, "k5": phase_k5}


def run_kernel_phases(names) -> int:
    """``chip_smoke.py --phase k5 [k1 ...]``: the build and the named kernel
    phases alone, each kernel against its plain version."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_device()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = [KERNEL_PHASES[name](dev, flush) for name in names]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "phases": list(names)}), flush=True)
    return 0


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
    if len(sys.argv) == 4 and sys.argv[1] == "--cli-rank":  # a process of phase_distributed
        sys.exit(cli_rank(sys.argv[2], int(sys.argv[3])))
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-load":  # the process of phase_serving
        sys.exit(serve_load(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--phase":
        sys.exit(run_kernel_phases(sys.argv[2:]))
    sys.exit(main())
