#!/usr/bin/env python3
"""End-to-end learning validation of the PyTorch port.

The counterpart of tools/validate_learning.py, on the same tree, config and
bar: trains PoseResNet-18 (64x64 crops, float32, B=4, 2000 steps) on a
synthetic camera-ring tree through the port's ``ActiveLearningStrategy``
and then evaluates MKPE on the *training* frames: a correct pipeline must
reach the stride-4 argmax quantization floor (~1.5 world units for this
rig, 3D-PCK@5 = 100%), MKPE < 3.0 and 3D-PCK@5 > 0.95.  This closes the
loop across the host data path, device GT synthesis, training, K1's
heatmap decode, RANSAC-DLT triangulation and the metrics.

``--int8_compare`` then scores the pool with float against int8
(TPU.INT8_SCORING) on the trained checkpoint, per strategy, and reports
ranking agreement (Spearman's rank correlation with a bootstrap CI, the
top-25% overlap, CORESET's selected-set overlap) against the same
per-strategy bar as the JAX tool, checks the port's int8 gates
(``engine.INT8_SAFE_STRATEGIES``, ``engine.INT8_MIXED_TAIL``) against it,
and prints the eval-MKPE delta of TPU.INT8_EVAL.

  python tools/validate_learning_torch.py [--steps 2000] [--frames 8]
      [--int8_compare] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is asked for.  Prints
``VALIDATION PASSED`` / ``FAILED`` and exits 0 / 1.  Imports nothing of
JAX.
"""

import argparse
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--num_aug", type=int, default=0)
    parser.add_argument(
        "--loss", default="MSE", choices=["MSE", "INTEGRAL", "MSE+INTEGRAL"],
        help="training objective (TRAIN.LOSS)",
    )
    parser.add_argument("--workdir",
                        default=os.path.join(tempfile.gettempdir(), "mval_validate_torch"))
    parser.add_argument(
        "--int8_compare", action="store_true",
        help="after validation, score the pool with float vs int8 "
        "(TPU.INT8_SCORING) on the trained checkpoint and report ranking "
        "agreement + eval-MKPE delta",
    )
    parser.add_argument(
        "--compare_pool", type=int, default=0,
        help="score a SEPARATE synthetic pool of this many frames for the "
        "int8 comparison (0 = reuse the training tree)",
    )
    parser.add_argument(
        "--bootstrap", type=int, default=1000,
        help="bootstrap resamples for the rank-correlation CI",
    )
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = parser.parse_args(argv)

    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.data import build_dataset
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
    from multi_view_active_learning_tpu_torch.device import use_deterministic_algorithms
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy
    from multi_view_active_learning_tpu_torch.utils import checkpoint as ckpt

    tree = generate_panoptic_tree(
        os.path.join(args.workdir, "tree"),
        num_train_frames=args.frames,
        num_val_frames=max(args.frames // 2, 2),
    )
    cfg = get_default_configs()
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = tree
    cfg.DATA.INPUT_WIDTH = 64
    cfg.DATA.INPUT_HEIGHT = 64
    cfg.DATA.EPOCH_SIZE = 2048
    cfg.DATA.NUM_AUG = args.num_aug
    cfg.DATA.AUG_MAGNITUDE = 9
    cfg.DATA.USE_ROTATION = False
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.LOSS = args.loss
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TRAIN.VAL_SIZE = 4
    cfg.TRAIN.OPTIM.TOTAL_STEPS = args.steps
    cfg.TRAIN.LOG_EVERY_ITER = max(args.steps // 4, 1)
    cfg.LOG_DIR = os.path.join(args.workdir, "logs")
    cfg.EXPR_NAME = "VALIDATE"

    strategy = ActiveLearningStrategy(cfg, device=args.device)
    use_deterministic_algorithms(strategy.device)  # runs replay bit for bit on the card
    train = build_dataset(cfg, "train")
    val = build_dataset(cfg, "val")
    t0 = time.time()
    strategy.run_fully_supervised_training(strategy.new_state(), train, val)
    print("train time: %.3fs" % (time.time() - t0))

    final = glob.glob(
        os.path.join(cfg.LOG_DIR, "VALIDATE", "FULLY_SUPERVISED", "checkpoints", "CKPT-FINAL")
    )[0]
    state = ckpt.restore_params_only(final, strategy.new_state())
    train2 = build_dataset(cfg, "train")
    train2.label_all()
    train2.resample_frames(-1, rng=np.random.default_rng(0))
    res = strategy._evaluate_all(-1, state, strategy._get_loader(train2, 4))
    pck5 = float(np.mean(res["pcks"][-1]))
    print("train-set MKPE: %.3f  3D-PCK@5: %.3f" % (res["mkpe"], pck5))
    ok = res["mkpe"] < 3.0 and pck5 > 0.95
    print("VALIDATION %s" % ("PASSED" if ok else "FAILED"))

    if ok and args.int8_compare:
        ok = _int8_compare(cfg, state, args) and ok
    return 0 if ok else 1


def _spearman_ci(a, b, n_boot: int, rng) -> tuple:
    """(rank_corr, ci_lo, ci_hi): Spearman correlation with a frame-level
    bootstrap CI, resampling frames with replacement."""
    def spearman(x, y):
        rx = np.argsort(np.argsort(x)).astype(np.float64)
        ry = np.argsort(np.argsort(y)).astype(np.float64)
        c = np.corrcoef(rx, ry)[0, 1]
        return float(c) if np.isfinite(c) else 0.0

    point = spearman(a, b)
    n = len(a)
    boots = np.empty(n_boot)
    for i in range(n_boot):
        idx = rng.integers(0, n, size=n)
        boots[i] = spearman(a[idx], b[idx])
    lo, hi = np.percentile(boots, [2.5, 97.5])
    return point, float(lo), float(hi)


def _int8_compare(cfg, state, args) -> bool:
    """Float-vs-int8 scoring on the trained checkpoint, per strategy, at
    tools/validate_learning.py's bar: a strategy is int8-safe iff the 95%
    bootstrap CI of the Spearman rank correlation lies above 0.9 and the
    top-25% overlap is at least 0.75 (CORESET: the k-center selected-set
    overlap over the triangulated poses finite in both arms is at least
    0.75).  Every strategy the port's gates run int8 (full or with a mixed
    float tail) must measure safe on that arm."""
    from multi_view_active_learning_tpu_torch import engine as engine_mod
    from multi_view_active_learning_tpu_torch.data import build_dataset
    from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
    from multi_view_active_learning_tpu_torch.ops import coreset as coreset_ops
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy

    if args.compare_pool:
        pool_tree = generate_panoptic_tree(
            os.path.join(args.workdir, "compare_pool_%d" % args.compare_pool),
            num_train_frames=args.compare_pool,
            num_val_frames=2,
            seed=7,
        )
        cfg = cfg.clone()
        cfg.DATA.SYNTHETIC_ROOT = pool_tree

    rng = np.random.default_rng(11)
    good = True
    sal = {}
    raw_ok = {}
    # (strategy, arm): arm None = float, 0 = full int8, 1 = mixed (1-stage tail).
    arms = [("TRIANGULATION", None), ("TRIANGULATION", 0),
            ("MPE", None), ("MPE", 0), ("MPE", 1),
            ("HP", None), ("HP", 0),
            ("BSB", None), ("BSB", 0), ("BSB", 1)]
    for strategy_name, arm in arms:
        c = cfg.clone()
        c.AL.STRATEGY = strategy_name
        c.TPU.INT8_SCORING = arm is not None
        # The raw behavior is the evidence; the gates are checked against it below.
        c.TPU.INT8_SCORING_FORCE = arm is not None
        c.TPU.INT8_FLOAT_TAIL_STAGES = arm or 0
        strat = ActiveLearningStrategy(c, device=args.device)
        pool = build_dataset(c, "train")
        pool.resample_unlabeled_data()
        sal[(strategy_name, arm)] = strat._compute_sal_dict(pool, state)

    for strategy_name, arm in arms:
        if arm is None:
            continue
        tag = "int8" if arm == 0 else "mixed(tail=%d)" % arm
        guids = list(sal[(strategy_name, None)]["al_metric"])
        a = np.asarray([sal[(strategy_name, None)]["al_metric"][g] for g in guids])
        b = np.asarray([sal[(strategy_name, arm)]["al_metric"][g] for g in guids])
        rank_corr, ci_lo, ci_hi = _spearman_ci(a, b, args.bootstrap, rng)
        k = max(len(guids) // 4, 1)
        topk_f32 = set(np.argsort(-a)[:k].tolist())
        topk_i8 = set(np.argsort(-b)[:k].tolist())
        overlap = len(topk_f32 & topk_i8) / k
        raw_ok[(strategy_name, arm)] = ci_lo > 0.9 and overlap >= 0.75
        print(
            "%s vs float [%s] (%d frames): rank_corr %.3f "
            "(95%% CI [%.3f, %.3f])  top-%d overlap %.2f  %s"
            % (tag, strategy_name, len(guids), rank_corr, ci_lo, ci_hi, k, overlap,
               "ok" if raw_ok[(strategy_name, arm)] else "unsafe")
        )

    # CORESET selects by triangulated pose: compare the selected sets over
    # the guids finite in both arms (one NaN row would win every k-center
    # argmax in both), and divide by the number actually selected.
    k = max(len(guids) // 4, 1)
    finite = {
        arm: {g: np.asarray(kp)
              for g, kp in sal[("TRIANGULATION", arm)]["pred_3d_keypoints"].items()
              if np.isfinite(kp).all()}
        for arm in (None, 0)
    }
    common = [g for g in finite[None] if g in finite[0]]
    n_sel = min(k, len(common))
    picks = {}
    for arm in (None, 0):
        cs = coreset_ops.CoreSet({g: finite[arm][g] for g in common}, {}, 2, device=args.device)
        picks[arm] = set(cs.select_batch(n_sel))
    coreset_overlap = len(picks[None] & picks[0]) / max(n_sel, 1)
    raw_ok[("CORESET", 0)] = coreset_overlap >= 0.75
    print(
        "int8 vs float [CORESET] top-%d selection overlap %.2f  %s"
        % (n_sel, coreset_overlap, "ok" if raw_ok[("CORESET", 0)] else "unsafe")
    )

    # The product contract: every strategy the port runs int8 (full or
    # mixed) measured safe on that arm.
    for (name, arm), arm_ok in raw_ok.items():
        if arm == 0:
            gated_on = name in engine_mod.INT8_SAFE_STRATEGIES
            tag = "full int8"
        else:
            gated_on = engine_mod.INT8_MIXED_TAIL.get(name) == arm
            tag = "mixed int8 (tail=%d)" % arm
        if gated_on and not arm_ok:
            print("GATE VIOLATION: %s defaults to %s but measured unsafe" % (name, tag))
            good = False
        if not gated_on and arm_ok:
            print("note: %s measured %s-safe here but the gate does not use it" % (name, tag))

    tri_f, tri_i = sal[("TRIANGULATION", None)], sal[("TRIANGULATION", 0)]
    mk_a = np.asarray([tri_f["mkpe"][g] for g in guids])
    mk_b = np.asarray([tri_i["mkpe"][g] for g in guids])
    print("median per-frame |MKPE delta| %.3f" % float(np.median(np.abs(mk_a - mk_b))))

    evals = {}
    for int8_eval in (False, True):
        c = cfg.clone()
        c.TPU.INT8_EVAL = int8_eval
        strat = ActiveLearningStrategy(c, device=args.device)
        val = build_dataset(c, "train")
        val.label_all()
        val.resample_frames(-1, rng=np.random.default_rng(0))
        evals[int8_eval] = strat._evaluate_all(-1, state, strat._get_loader(val, 4))
    print(
        "eval MKPE float %.3f vs int8 %.3f (delta %.3f)"
        % (evals[False]["mkpe"], evals[True]["mkpe"], evals[True]["mkpe"] - evals[False]["mkpe"])
    )
    print("INT8 COMPARE %s" % ("PASSED" if good else "FAILED"))
    return good


if __name__ == "__main__":
    sys.exit(main())
