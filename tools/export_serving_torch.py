#!/usr/bin/env python3
"""Export a trained model of the PyTorch port as a ``.pt2`` serving artifact.

See multi_view_active_learning_tpu_torch/serving.py for the artifact
contract (uint8 pixels + square boxes in; heatmaps, decoded keypoints,
confidences out; weights baked in) and what loading it needs (torch and
the port's kernel-operator registrations).  The counterpart of
tools/export_serving.py.

Usage:
  python tools/export_serving_torch.py --ckpt <CKPT-FINAL> --out model.pt2 \
      [--config_file experiments/foo.yaml] [--model POSE_RESNET]
      [--num_layers 50] [--num_joints 19] --views 31 \
      [--batch 4 | --symbolic-batch] [--int8-calib images.npz] [--selftest]
      [--device cpu]

  --ckpt: a checkpoint of the port (``utils/checkpoint.py``: CKPT-FINAL,
    CKPT-E<step>-..., or a reference ``.pth``); omitted = a fresh seeded
    init, for plumbing tests.
  --int8-calib: .npz with an ``images`` uint8 array [B, V, H, W, 3]; bakes
    the int8 backbone in, calibrated on that batch.
  --device: where to trace and run the artifact (default the CUDA card;
    ``cpu`` only when asked).  Imports nothing of JAX.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", default=None, help="a port checkpoint file "
                        "(omitted = fresh init, for artifact plumbing tests)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--model", default=None, help="POSE_RESNET | HRNET")
    parser.add_argument("--num_layers", type=int, default=None)
    parser.add_argument("--num_joints", type=int, default=None)
    parser.add_argument("--views", type=int, default=31)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument(
        "--symbolic-batch", action="store_true",
        help="export a symbolic batch dim (one artifact, any request size)",
    )
    parser.add_argument("--int8-calib", default=None)
    parser.add_argument(
        "--selftest", action="store_true",
        help="load the written artifact and run one random batch",
    )
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = parser.parse_args(argv)

    import torch

    from multi_view_active_learning_tpu_torch import serving
    from multi_view_active_learning_tpu_torch.config import load_config
    from multi_view_active_learning_tpu_torch.engine import Engine
    from multi_view_active_learning_tpu_torch.utils import checkpoint as ckpt_utils

    cfg = load_config(args.config_file)
    if args.model:
        cfg.POSE_ESTIMATOR.TYPE = args.model
    if args.num_layers is not None:
        cfg.POSE_ESTIMATOR.NUM_LAYERS = args.num_layers
    if args.num_joints is not None:
        cfg.DATA.NUM_JOINTS = args.num_joints
    if args.int8_calib:
        # An explicit request: the int8 path on for every model family and
        # strategy (the per-strategy gates protect selection, which a
        # frozen serving artifact never runs), as tools/export_serving.py.
        cfg.TPU.INT8_SCORING = True
        cfg.TPU.INT8_SCORING_HRNET = True
        cfg.TPU.INT8_SCORING_FORCE = True

    engine = Engine(cfg, device=args.device)
    state = engine.init_state(torch.Generator().manual_seed(0))
    if args.ckpt:
        state = ckpt_utils.restore_params_only(args.ckpt, state)
    else:
        print("WARNING: no --ckpt; exporting freshly initialized weights")

    int8_scales = None
    if args.int8_calib:
        engine.use_state(state)
        int8_scales = engine.int8_calibrate(np.load(args.int8_calib)["images"])

    ep = serving.export_serving(engine, state, None if args.symbolic_batch else args.batch,
                                args.views, int8_scales=int8_scales)
    serving.save_serving(ep, args.out)
    print("wrote %s (%.1f MB): %s -> (confidence, heatmaps, keypoints)"
          % (args.out, os.path.getsize(args.out) / 1e6, serving.input_shapes(ep)))

    if args.selftest:
        call = serving.load_serving(args.out, device=engine.device)
        B = 1 if args.symbolic_batch else args.batch
        H, W = cfg.DATA.INPUT_HEIGHT, cfg.DATA.INPUT_WIDTH
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, size=(B, args.views, H, W, 3)).astype(np.uint8)
        box = np.tile(np.asarray([0, 0, 256, 256], np.float32), (B, args.views, 1))
        out = call(images, box)
        print("selftest ok: heatmaps %s, keypoints %s, confidence mean %.4f"
              % (tuple(out["heatmaps"].shape), tuple(out["keypoints"].shape),
                 float(out["confidence"].mean())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
