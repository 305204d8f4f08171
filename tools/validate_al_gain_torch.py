#!/usr/bin/env python3
"""End-to-end proof that active learning beats random selection, on the
PyTorch port: the counterpart of tools/validate_al_gain.py, with the same
pool, flags and defaults.

Runs matched-budget AL loops (TRIANGULATION / MPE / CORESET vs RANDOM)
through the REAL workflow AL path (workflow.run_experiment, EXPR_TYPE=AL:
per-iteration scoring -> selection -> guid logs -> fresh-model training ->
chained AL_EVAL size->MKPE curves) on a synthetic pool with genuinely
heterogeneous frame difficulty (data/synthetic.py::
generate_heterogeneous_tree), multi-seed, and compares the learning curves.

This exercises the WACV'23 claim the reference implements (reference
README.md:5-13; the size->MKPE curve machinery at reference
strategy.py:193-226): AL-selected frames yield lower MKPE than random at
equal annotation budget.

The pool: COMMON frames are a redundant correlated walk a color-template
shortcut solves; HARD frames carry per-view distractor discs pointwise
identical to real joints, so the shortcut detector mislocalizes per view at
random until hard frames enter the labeled set and the bone-attachment cue
is learned.  AL strategies see hard frames directly (triangulation
disagreement / multi-peak heatmaps / pose diversity); RANDOM finds them
only at base rate.

Run on the CUDA card (default) or the CPU (``--device cpu``, slow):
  python tools/validate_al_gain_torch.py [--seeds 3] [--steps 2000]
  python tools/validate_al_gain_torch.py --calibrate   # pool-viability check

Calibrate mode answers two prerequisites in ~2 train runs:
  1. a model trained WITHOUT hard frames must measure much worse on hard
     val frames than common ones (the confusion exists), and
  2. a model trained WITH hard frames must close most of that gap (the
     discrimination is learnable) — i.e. the difficulty is epistemic.

Everything goes through the port: ``workflow.run_experiment``,
``ActiveLearningStrategy`` and ``data/synthetic.py::
generate_heterogeneous_tree``.  Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_tree(args) -> str:
    from multi_view_active_learning_tpu_torch.data.synthetic import (
        generate_heterogeneous_tree,
    )

    tree = os.path.join(args.workdir, "tree")
    if not os.path.exists(os.path.join(tree, "meta.json")):
        print("Generating heterogeneous tree at %s ..." % tree)
        generate_heterogeneous_tree(
            tree,
            num_common=args.num_common,
            num_hard=args.num_hard,
            num_distractors=args.num_distractors,
            seed=0,
        )
    return tree


def base_config(args, tree: str):
    from multi_view_active_learning_tpu_torch.config import get_default_configs

    cfg = get_default_configs()
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = tree
    cfg.DATA.INPUT_WIDTH = 64
    cfg.DATA.INPUT_HEIGHT = 64
    cfg.DATA.EPOCH_SIZE = 2048
    # Rotation-only augmentation: tiny labeled sets memorize otherwise
    # (the calibration probe measured val MKPE ~90 on held-out frames of
    # the TRAINED scene without it), and the image-color ops would destroy
    # the joint color coding the synthetic task is built on.
    cfg.DATA.NUM_AUG = 1
    cfg.DATA.AUG_MAGNITUDE = 9
    cfg.DATA.USE_ROTATION = True
    cfg.DATA.USE_IMAGE_AUG = False
    cfg.DATA.USE_CONST_AUG_MAGNITUDE = False
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TRAIN.VAL_SIZE = 8
    cfg.TRAIN.OPTIM.TOTAL_STEPS = args.steps
    # One checkpoint/eval point at the end of each iteration's training:
    # the AL loop only consumes CKPT-FINAL.
    cfg.TRAIN.LOG_EVERY_ITER = args.steps
    cfg.AL.INITIAL_AMOUNT = args.initial_amount
    cfg.AL.ITER_AMOUNT = args.iter_amount
    cfg.AL.ITERATIONS = args.iterations
    cfg.AL.INFERENCE.BATCH_SIZE = 4
    cfg.SAL.NUM_FRAMES = [0]
    cfg.LOG_DIR = os.path.join(args.workdir, "logs")
    return cfg


def run_one(args, tree: str, strategy: str, seed: int):
    """One full AL experiment through workflow.run_experiment; returns
    (sizes->mkpe curve, per-iteration hard-frame pick counts)."""
    from multi_view_active_learning_tpu_torch import workflow

    cfg = base_config(args, tree)
    cfg.EXPR_TYPE = "AL"
    cfg.AL.STRATEGY = strategy
    cfg.RANDOM_SEED = 1307 + seed
    cfg.EXPR_NAME = "ALGAIN-%s-s%d" % (strategy, seed)
    t0 = time.time()
    result = workflow.run_experiment(cfg, device=args.device)
    dt = time.time() - t0

    with open(os.path.join(tree, "meta.json")) as f:
        meta = json.load(f)
    hard = set(meta["hard_guids"])
    picks = []
    for it in range(cfg.AL.ITERATIONS):
        path = os.path.join(
            cfg.LOG_DIR, cfg.EXPR_NAME, "SAMPLED-GUID-ITER-%d" % it
        )
        with open(path) as f:
            guids = json.load(f)
        picks.append(sum(1 for g in guids if g in hard))
    curve = {int(size): float(result[size]["mkpe"]) for size in result}
    print(
        "[%s seed %d] %.0fs  curve %s  hard picks/iter %s"
        % (strategy, seed, dt,
           {s: round(m, 2) for s, m in sorted(curve.items())}, picks)
    )
    return curve, picks


def calibrate(args, tree: str) -> int:
    """Pool-viability check (see module docstring)."""
    from multi_view_active_learning_tpu_torch.data import build_dataset
    from multi_view_active_learning_tpu_torch.device import use_deterministic_algorithms
    from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy

    with open(os.path.join(tree, "meta.json")) as f:
        meta = json.load(f)

    def train_and_probe(label_guids, tag):
        cfg = base_config(args, tree)
        cfg.AL.STRATEGY = "TRIANGULATION"  # probe mirrors the scoring arm
        cfg.EXPR_NAME = "CALIB-%s" % tag
        strategy = ActiveLearningStrategy(cfg, device=args.device)
        use_deterministic_algorithms(strategy.device)  # as workflow.run_experiment does
        train = build_dataset(cfg, "train")
        train.label_by_frame_guids(label_guids)
        val = build_dataset(cfg, "val")
        tcfg = cfg.clone()
        tcfg.EXPR_NAME = tcfg.EXPR_NAME + "/TRAIN"
        state = strategy._train(-1, tcfg, train, val, strategy.new_state())
        probe = build_dataset(cfg, "val")
        probe.resample_unlabeled_data()
        sal = strategy._compute_sal_dict(probe, state)
        hard = set(meta["val_hard_guids"])
        mk = sal["mkpe"]
        mk_hard = float(np.mean([mk[g] for g in mk if g in hard]))
        mk_common = float(np.mean([mk[g] for g in mk if g not in hard]))
        tri = sal["sal_metric"]
        tri_hard = float(np.nanmean([tri[g] for g in tri if g in hard]))
        tri_common = float(np.nanmean([tri[g] for g in tri if g not in hard]))
        print(
            "[calib %s] val MKPE hard %.2f vs common %.2f | "
            "triangulation metric hard %.2f vs common %.2f"
            % (tag, mk_hard, mk_common, tri_hard, tri_common)
        )
        return mk_hard, mk_common

    n = args.initial_amount + (args.iterations - 1) * args.iter_amount
    common_only = meta["common_guids"][:n]
    hard_n, _ = train_and_probe(common_only, "common-only")
    mixed = (
        meta["common_guids"][: max(n - len(meta["hard_guids"]), 0)]
        + meta["hard_guids"]
    )[:n]
    hard_m, _ = train_and_probe(mixed, "with-hard")
    print(
        "calibration: hard-val MKPE %.2f (common-only) -> %.2f (with-hard); "
        "confusion %s, learnable %s"
        % (
            hard_n,
            hard_m,
            "YES" if hard_n > 2 * max(hard_m, 1.0) else "WEAK",
            "YES" if hard_m < 0.5 * hard_n else "WEAK",
        )
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir",
                        default=os.path.join(tempfile.gettempdir(), "mval_algain_torch"))
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--iterations", type=int, default=4)
    parser.add_argument("--initial_amount", type=int, default=8)
    parser.add_argument("--iter_amount", type=int, default=8)
    parser.add_argument("--num_common", type=int, default=80)
    parser.add_argument("--num_hard", type=int, default=16)
    parser.add_argument("--num_distractors", type=int, default=12)
    parser.add_argument(
        "--strategies", default="RANDOM,TRIANGULATION,MPE,CORESET"
    )
    parser.add_argument("--calibrate", action="store_true")
    parser.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = parser.parse_args(argv)

    tree = make_tree(args)
    if args.calibrate:
        return calibrate(args, tree)

    strategies = args.strategies.split(",")
    results = {}  # strategy -> seed -> {"curve": {...}, "picks": [...]}
    for strategy in strategies:
        results[strategy] = {}
        for seed in range(args.seeds):
            curve, picks = run_one(args, tree, strategy, seed)
            results[strategy][seed] = {"curve": curve, "picks": picks}
            with open(
                os.path.join(args.workdir, "algain_results.json"), "w"
            ) as f:
                json.dump(results, f, indent=1)

    # ---- summary table: per-size mean +- std across seeds ----
    sizes = sorted(
        {int(s) for r in results.values() for v in r.values()
         for s in v["curve"]}
    )
    print("\n=== AL-vs-RANDOM learning curves (test MKPE, %d seeds) ==="
          % args.seeds)
    header = "size    " + "".join("%-22s" % s for s in strategies)
    print(header)
    for size in sizes:
        row = "%-8d" % size
        for strategy in strategies:
            vals = [
                results[strategy][seed]["curve"].get(size)
                for seed in results[strategy]
                if results[strategy][seed]["curve"].get(size) is not None
            ]
            row += "%-22s" % (
                "%.2f +- %.2f" % (float(np.mean(vals)), float(np.std(vals)))
                if vals else "-"
            )
        print(row)
    print("\nhard-frame picks per iteration (of %d hard in pool, mean):"
          % args.num_hard)
    for strategy in strategies:
        per_iter = np.mean(
            [results[strategy][seed]["picks"] for seed in results[strategy]],
            axis=0,
        )
        print("  %-14s %s  (total %.1f)"
              % (strategy, np.round(per_iter, 1).tolist(),
                 float(np.sum(per_iter))))

    if "RANDOM" in results and len(strategies) > 1:
        final = sizes[-1]
        rand = np.mean([
            results["RANDOM"][s]["curve"][final] for s in results["RANDOM"]
        ])
        print("\nfinal-budget (size %d) MKPE vs RANDOM (%.2f):" % (final, rand))
        for strategy in strategies:
            if strategy == "RANDOM":
                continue
            vals = [
                results[strategy][s]["curve"][final]
                for s in results[strategy]
            ]
            m = float(np.mean(vals))
            print(
                "  %-14s %.2f  (%+.1f%%, %s)"
                % (strategy, m, 100 * (m - rand) / rand,
                   "BEATS RANDOM" if m < rand else "does NOT beat random")
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
