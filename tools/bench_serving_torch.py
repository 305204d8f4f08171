#!/usr/bin/env python3
"""Serving latency / throughput of the PyTorch port's ``.pt2`` artifact.

The counterpart of tools/bench_serving.py.  Exports the serve function
(multi_view_active_learning_tpu_torch/serving.py: uint8 pixels + square
boxes in -> heatmaps / keypoints / confidences out) with a symbolic batch,
saves it, loads it back as a serving tier would, and measures it the way
that tier experiences it:

  * per-request round-trip latency at B=1, each request's scalar result
    back on the host before the next request is issued, as p50 / p90 / p99
    over ``--requests``;
  * sustained throughput at each of ``--batches``, requests chained
    through their outputs, the median of three timed runs of 20.

  python tools/bench_serving_torch.py [--model POSE_RESNET|HRNET] [--views 31]
      [--img 256] [--num_layers 50] [--requests 50] [--batches 1,4] [--int8] [--warmup_s 20]
      [--device cpu] [--artifact model.pt2]

Prints one JSON line with tools/bench_serving.py's keys:
  {"latency_ms": {"p50": ..., "p90": ..., "p99": ...},
   "throughput_frames_per_sec": {"1": ..., "4": ...}, ...}
plus the device's name and, on a card, its power limit as nvidia-smi
gives them, the export seconds and the artifact's MB.  Seeded random
weights (PoseResNet-50 or HRNet-W32, bf16 compute); ``--int8`` bakes the
int8 backbone in with static scales calibrated on a 2-frame request.
``--artifact`` benches a saved artifact instead (its description gives
the model, views, image size and int8; a static batch serves only its
own size).
Runs on the CUDA card unless ``--device cpu`` is asked for; imports
nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _power_limit():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="POSE_RESNET", choices=["POSE_RESNET", "HRNET"])
    parser.add_argument("--views", type=int, default=31)
    parser.add_argument("--img", type=int, default=256)
    parser.add_argument("--joints", type=int, default=19)
    parser.add_argument("--num_layers", type=int, default=50, help="PoseResNet depth")
    parser.add_argument("--requests", type=int, default=50)
    parser.add_argument("--batches", default="1,4")
    parser.add_argument("--int8", action="store_true",
                        help="bake the int8 backbone in (static scales)")
    parser.add_argument("--warmup_s", type=float, default=20.0,
                        help="seconds of sustained requests before each measurement")
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    parser.add_argument("--artifact", default=None, help="bench this .pt2 instead of exporting")
    args = parser.parse_args(argv)

    import torch

    from multi_view_active_learning_tpu_torch import serving

    if args.artifact:
        serve = serving.load_serving(args.artifact, device=args.device)
        meta = serve.meta
        args.model, args.int8 = meta["model"], meta["int8"]
        V, IMG = meta["views"], meta["input_hw"][0]
        dev = serve.device
        result = {"export_s": None, "artifact_mb": os.path.getsize(args.artifact) / 1e6}
    else:
        serve, dev, result = _export(args)
        V, IMG = args.views, args.img
    result = {"model": args.model, "views": V, "img": IMG, "int8": bool(args.int8),
              "path": "pt2", **result}
    rng = np.random.default_rng(0)

    def request(B):
        images = rng.integers(0, 256, size=(B, V, IMG, IMG, 3)).astype(np.uint8)
        box = np.tile(np.asarray([0.0, 0.0, IMG, IMG], np.float32), (B, V, 1))
        return torch.from_numpy(images).to(dev), torch.from_numpy(box).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- per-request latency at B=1 (host round trip each request) ----
    images, box = request(1)

    def one():
        out = serve(images, box)
        return float(out["confidence"][0, 0, 0])

    for _ in range(3):
        one()
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < args.warmup_s:
        one()
    lat = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        one()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(sorted(lat))
    result["latency_ms"] = {q: float(np.percentile(lat, p))
                            for q, p in (("p50", 50), ("p90", 90), ("p99", 99))}

    # ---- sustained throughput per batch size (chained requests) -------
    result["throughput_frames_per_sec"] = {}
    for B in [int(b) for b in args.batches.split(",")]:
        images, box = request(B)
        carry = torch.zeros((), dtype=torch.uint8, device=dev)

        def chained(n):
            nonlocal carry
            for _ in range(n):
                out = serve(images + carry, box)
                carry = (out["confidence"][0, 0, 0] * 0.0).to(torch.uint8)
            float(carry)

        chained(3)
        t_warm = time.perf_counter()
        while time.perf_counter() - t_warm < args.warmup_s:
            chained(10)
        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            chained(20)
            times.append(time.perf_counter() - t0)
        result["throughput_frames_per_sec"][str(B)] = 20 * B / sorted(times)[1]

    if dev.type == "cuda":
        result["device"] = torch.cuda.get_device_name(dev)
        result["card"] = _power_limit()
    else:
        result["device"] = "cpu"
    print(json.dumps(result))
    return 0


def _export(args):
    """Seeded weights -> a symbolic-batch artifact, saved and loaded back:
    (serve, device, {"export_s", "artifact_mb"})."""
    import shutil

    import torch

    from multi_view_active_learning_tpu_torch import serving
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.engine import Engine

    cfg = get_default_configs()
    cfg.DATA.NUM_JOINTS = args.joints
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = args.img
    cfg.POSE_ESTIMATOR.TYPE = args.model
    cfg.POSE_ESTIMATOR.NUM_LAYERS = args.num_layers
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.INT8_SCORING = bool(args.int8)
    cfg.TPU.INT8_SCORING_HRNET = bool(args.int8)
    engine = Engine(cfg, device=args.device)
    state = engine.init_state(torch.Generator().manual_seed(0))
    engine.use_state(state)
    int8_scales = None
    if args.int8:
        rng = np.random.default_rng(1)
        calib = rng.integers(0, 256, size=(2, args.views, args.img, args.img, 3)).astype(np.uint8)
        int8_scales = engine.int8_calibrate(calib)
    workdir = tempfile.mkdtemp(prefix="bench_serving_")
    path = os.path.join(workdir, "serve" + serving.SERVING_SUFFIX)
    t0 = time.perf_counter()
    ep = serving.export_serving(engine, state, None, args.views, int8_scales=int8_scales)
    export_s = time.perf_counter() - t0
    serving.save_serving(ep, path)
    size_mb = os.path.getsize(path) / 1e6
    serve = serving.load_serving(path, device=engine.device)
    shutil.rmtree(workdir)
    return serve, engine.device, {"export_s": export_s, "artifact_mb": size_mb}


if __name__ == "__main__":
    sys.exit(main())
