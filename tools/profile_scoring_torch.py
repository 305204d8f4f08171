#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's scoring step on one CUDA card.

    python3 tools/profile_scoring_torch.py [--model POSE_RESNET|HRNET] [--steps 3] [--top 8]

Drives ``Engine.score_step`` at chip_smoke.py's bench width (B=4 frames x
V=31 views of 256x256 crops, K=19, 64 RANSAC pairs, seeded random weights).
PoseResNet-50 on four paths: float bf16 with the standard head, the int8
backbone (the default configuration), int8 with the K4 head, and bf16 with
the K3 head.  HRNet-W32 (``--model HRNET``) on four: float bf16 scoring
TRIANGULATION, MPE, and TRIANGULATION with AL.DIRECT_OPTIMIZATION, and the
int8 backbone (TPU.INT8_SCORING_HRNET).  The int8 paths are calibrated on
the batch first.  Each path
runs `--steps` host-timed steps, then `--steps` steps under torch.profiler
(CPU and CUDA activity).  Prints one JSON line per path: the host step
time, the device kernel time per step and its share of the step (the rest
is device idle), the device time per step by kernel class, and the top
kernels by device time.  Exits nonzero without a CUDA device.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Kernel-name substrings -> class, first match wins (cuDNN's implicit-GEMM
# convolutions also carry "gemm", so convolutions are matched first).
CLASSES = (
    ("K1 fused decode", ("decode_bulk_kernel", "decode_ragged_kernel")),  # csrc/decode.cu
    ("K2 min distance", ("min_distance_kernel",)),  # csrc/pairwise.cu
    ("convolution (cuDNN)", ("fprop", "dgrad", "conv", "cudnn", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "imma", "xmma", "cutlass", "gemv", "sm90_")),
    ("copy / index / cat", ("copy", "cat", "index", "gather", "scatter", "pad")),
    ("pooling", ("max_pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name: str) -> str:
    name_ = name.replace(" ", "")
    # csrc/deconv.cu: deconv_wgmma_kernel<kInt8, Tout>, K4's quantize
    # pre-pass, and K3's float32 kernel.
    if "deconv_quantize_kernel" in name_ or "deconv_wgmma_kernel<true" in name_:
        return "K4 fused deconv (int8)"
    if "deconv_wgmma_kernel" in name_ or "deconv_f32_kernel" in name_:
        return "K3 fused deconv"
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def profile_path(engine, args, scales, steps, top, strategy="TRIANGULATION"):
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        return engine.score_step(*args, al_strategy=strategy, int8_scales=scales)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    by_class = collections.defaultdict(float)
    for e in kernels:
        by_class[kernel_class(e.key)] += e.self_device_time_total / 1e3 / steps
    device_ms = sum(by_class.values())
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return dict(
        step_ms=step_ms, device_ms=device_ms,
        device_busy_share=device_ms / step_ms, launches_per_step=sum(e.count for e in kernels) / steps,
        by_class_ms={k: v for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        top=[dict(kernel=e.key[:120], ms_per_step=e.self_device_time_total / 1e3 / steps,
                  calls_per_step=e.count / steps) for e in ranked],
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("POSE_RESNET", "HRNET"), default="POSE_RESNET")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=8)
    opts = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_scoring_torch: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from multi_view_active_learning_tpu_torch.models import PoseResNet

    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    if opts.model == "HRNET":
        state_dict = cs.hrnet_state_dict()
        # name: (TPU options, AL options, strategy)
        paths = {"float_bf16": ({}, None, "TRIANGULATION"), "float_bf16_mpe": ({}, None, "MPE"),
                 "float_bf16_direct": ({}, dict(DIRECT_OPTIMIZATION=True), "TRIANGULATION"),
                 "int8": (dict(INT8_SCORING=True, INT8_SCORING_HRNET=True), None, "TRIANGULATION")}
    else:
        state_dict = cs.random_state_dict(PoseResNet(cs.JOINTS, cs.DEPTH), seed=7)
        paths = {"float_bf16": ({}, None, "TRIANGULATION"),
                 **{name: (tpu, None, "TRIANGULATION") for name, (tpu, _) in cs.PATHS.items()}}
    rng = np.random.default_rng(4)
    images = torch.from_numpy(
        rng.integers(0, 256, size=(cs.BATCH, cs.VIEWS, cs.IMG, cs.IMG, 3)).astype(np.uint8)).to(dev)
    proj = torch.from_numpy(np.broadcast_to(
        cs.make_ring_cameras(cs.VIEWS, img=cs.IMG), (cs.BATCH, cs.VIEWS, 3, 4)).copy()).to(dev)
    valid = torch.ones((cs.BATCH, cs.JOINTS), dtype=torch.bool, device=dev)
    gt = torch.from_numpy(rng.normal(scale=30.0, size=(cs.BATCH, cs.JOINTS, 3)).astype(np.float32)).to(dev)
    for name, (tpu, al, strategy) in paths.items():
        engine = cs._engine("bfloat16", dev, state_dict, model=opts.model, al=al, **tpu)
        pairs = torch.from_numpy(engine.pairs(cs.VIEWS)).to(dev)
        scales = engine.int8_calibrate(images)
        row = profile_path(engine, (images, proj, valid, pairs, gt), scales, opts.steps, opts.top,
                           strategy)
        print(json.dumps({"path": name, "model": opts.model, "options": tpu, "al": al,
                          "strategy": strategy, "batch": cs.BATCH, "views": cs.VIEWS, "img": cs.IMG,
                          "depth": cs.DEPTH if opts.model == "POSE_RESNET" else None,
                          "device": smi, **row}), flush=True)
        del engine
    return 0


if __name__ == "__main__":
    sys.exit(main())
