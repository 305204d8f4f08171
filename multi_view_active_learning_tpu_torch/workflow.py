"""Experiment driver and CLI of the port.

    python -m multi_view_active_learning_tpu_torch.workflow --config_file exp.yaml [--device cpu]
    python -m torch.distributed.run --nproc_per_node N \
        -m multi_view_active_learning_tpu_torch.workflow --config_file exp.yaml [--device cpu]

The port's counterpart of the JAX package's workflow.py (:41-263 there;
reference: workflow.py:29-273): the six EXPR_TYPEs, in one process or in
one process a card under torchrun (NCCL between cards, gloo with
``--device cpu``) over the ``TPU.DATA_AXIS`` x ``TPU.VIEW_AXIS`` mesh
(``parallel``): each data row computes its shard of each global batch of
TRAIN.BATCH_SIZE x data frames, each rank of a row its block of the views
when the view axis divides them, and rank 0 writes.

  * AL / SAL: for each iteration from AL.START_ITER (after copying the
    earlier iterations' checkpoints and guid logs from
    AL.PREVIOUS_AL_LOG_DIR), a fresh strategy replays the guid logs, scores
    and selects with the previous iteration's CKPT-FINAL (iteration 0 draws
    at random), and trains a fresh model (``new_state(salt=1000 +
    iteration)``); then AL_EVAL over the iterations' checkpoints.
  * SUPERVISED: trains on the labeled pool, then EVAL of its CKPT-FINAL.
  * AL_EVAL / EVAL: the test split against checkpoints.
  * CLUSTER: per-frame poses or losses (the reference's "CLUSETER" typo
    made it unreachable there; the JAX package fixed it).

Every artifact hangs off ``EXPR_NAME-<timestamp>`` under LOG_DIR, and the
results are written as JSON to RESULTS (a temporary file when unset).
The run uses the CUDA card (the rank's, ``LOCAL_RANK``) unless
``--device`` (or ``device=``) names another device: the port's counterpart
of JAX_PLATFORMS.  Without a card and without ``--device cpu`` it raises
(device.resolve_device).  ``TPU.VIEW_AXIS`` must divide the number of
processes and ``TPU.DATA_AXIS`` be -1 or the rest (ValueError, as JAX's
make_mesh).  On a card the run uses cuDNN's deterministic algorithms
(``device.use_deterministic_algorithms``), so it replays bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from datetime import datetime
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from . import config as config_lib
from . import parallel
from .data import build_dataset
from .device import resolve_device, use_deterministic_algorithms
from .strategy import ActiveLearningStrategy
from .utils import checkpoint as ckpt
from .utils import get_logger, storage
from .utils.metrics_writer import MetricsWriter


class FlowOutput(NamedTuple):
    """Result summary (reference: workflow.py:142-206)."""

    sizes: List[int]
    mkpes: List[float]
    pck_thresholds: List[float]
    pcks: List[List[float]]
    pckh_thresholds: List[float]
    pckhs: List[List[float]]
    avg_mkpe: float
    avg_pcks: List[float]
    avg_pckhs: List[float]
    strategy: str
    num_aug: int
    magnitude_aug: int
    pose_estimator: str
    dataset: str
    sigma: float
    input_cfg: str
    expr_name: str


def prepare_output(cfg, eval_dict: Dict) -> FlowOutput:
    sizes, mkpes, pcks, avg_pcks = [], [], [], []
    pckhs, avg_pckhs = [], []
    pck_thresholds: List[float] = []
    pckh_thresholds: List[float] = [0.0]
    for size in eval_dict:
        result = eval_dict[size]
        sizes.append(int(size))
        mkpes.append(result["mkpe"])
        pcks.append(result["pcks"])
        avg_pcks.append(float(np.mean(result["pcks"])))
        pck_thresholds = result["thresholds"]
        if "pckh_thresholds" in result:
            pckh_thresholds = result["pckh_thresholds"]
            pckhs.append(result["pckh_pcks"])
            avg_pckhs.append(float(np.mean(result["pckh_pcks"])))
        else:
            pckhs.append([0.0])
            avg_pckhs.append(0.0)
    return FlowOutput(
        sizes=sizes, mkpes=mkpes, pck_thresholds=pck_thresholds, pcks=pcks,
        pckh_thresholds=pckh_thresholds, pckhs=pckhs,
        avg_mkpe=float(np.mean(mkpes)) if mkpes else float("nan"),
        avg_pcks=avg_pcks, avg_pckhs=avg_pckhs, strategy=cfg.AL.STRATEGY,
        num_aug=cfg.DATA.NUM_AUG, magnitude_aug=cfg.DATA.AUG_MAGNITUDE,
        pose_estimator=cfg.POSE_ESTIMATOR.TYPE, dataset=cfg.DATA.TYPE, sigma=cfg.DATA.SIGMA,
        input_cfg=cfg.dump(), expr_name=cfg.EXPR_NAME)


def run_al_iteration(cfg, iteration: int, device=None) -> None:
    """One AL / SAL iteration: restore the pool from the guid logs, score
    and select, retrain (reference: workflow.py:36-80).  The strategy is
    new each iteration, as the reference's processes are."""
    logger = get_logger("workflow")
    it_cfg = cfg.clone()
    it_cfg.AL.CURRENT_ITER = iteration
    strategy = ActiveLearningStrategy(it_cfg, device)
    # The experiment's AL writer, attached again (it appends).
    strategy.al_writer = MetricsWriter(strategy._expr_dir("AL"))
    state = strategy.new_state(salt=iteration)
    if iteration == 0:
        amount = cfg.AL.INITIAL_AMOUNT
    else:
        restore_path = os.path.join(cfg.LOG_DIR, cfg.EXPR_NAME, "ITER-%d" % (iteration - 1),
                                    "checkpoints", "CKPT-FINAL")
        logger.info("Restoring scorer weights from %s" % restore_path)
        state = ckpt.restore_params_only(restore_path, state)
        amount = cfg.AL.ITER_AMOUNT
    train_pool = build_dataset(it_cfg, "train")
    val_pool = build_dataset(it_cfg, "val")
    train_pool = strategy.restore_dataset(train_pool, iteration)
    sal_frames = cfg.SAL.NUM_FRAMES[min(iteration, len(cfg.SAL.NUM_FRAMES) - 1)]
    train_pool = strategy.sample_next_batch(train_pool, amount, sal_frames, state, iteration)
    # A fresh model each iteration (reference: workflow.py:72-73).
    strategy.al_iteration(strategy.new_state(salt=1000 + iteration), train_pool, val_pool,
                          iteration)
    strategy.al_writer.close()


def run_experiment(cfg, device=None) -> Dict:
    """Dispatch on EXPR_TYPE; returns the eval dict (empty for CLUSTER).
    Every rank writes its result to RESULTS, as the JAX package does."""
    logger = get_logger("workflow")
    use_deterministic_algorithms(resolve_device(device))
    if parallel.initialize_distributed(device=device):
        logger.info("Distributed: process %d/%d" % (parallel.process_index(),
                                                     parallel.process_count()))
    logger.info("Mesh: %s" % (parallel.mesh_from_config(cfg),))
    result: Dict = {}
    if cfg.EXPR_TYPE in ("AL", "SAL"):
        strategy = ActiveLearningStrategy(cfg, device)
        strategy.prepare_al_experiments()
        if cfg.AL.START_ITER != 0:
            if not cfg.AL.PREVIOUS_AL_LOG_DIR:
                raise ValueError("AL.START_ITER != 0 requires AL.PREVIOUS_AL_LOG_DIR")
            if parallel.is_main():  # one writer to the shared log directory
                strategy._copy_previous_checkpoints()
            parallel.process_barrier("copy-prev-ckpts/%s" % cfg.EXPR_NAME)
        strategy.al_writer.close()
        del strategy
        for iteration in range(cfg.AL.START_ITER, cfg.AL.ITERATIONS):
            run_al_iteration(cfg, iteration, device)
        eval_cfg = cfg.clone()
        eval_cfg.EXPR_TYPE = "AL_EVAL"
        eval_cfg.AL.INFERENCE.TRAINING_EXPR_NAME = eval_cfg.EXPR_NAME
        result = run_experiment_eval(eval_cfg, device)
    elif cfg.EXPR_TYPE == "SUPERVISED":
        strategy = ActiveLearningStrategy(cfg, device)
        strategy.run_fully_supervised_training(strategy.new_state(), build_dataset(cfg, "train"),
                                               build_dataset(cfg, "val"))
        del strategy
        eval_cfg = cfg.clone()
        eval_cfg.EXPR_TYPE = "EVAL"
        eval_cfg.AL.INFERENCE.RESTORE_FROM = ckpt.final_ckpt_path(cfg.LOG_DIR, cfg.EXPR_NAME,
                                                                  "FULLY_SUPERVISED")
        result = run_experiment_eval(eval_cfg, device)
    elif cfg.EXPR_TYPE in ("AL_EVAL", "EVAL"):
        result = run_experiment_eval(cfg, device)
    elif cfg.EXPR_TYPE == "CLUSTER":
        strategy = ActiveLearningStrategy(cfg, device)
        strategy.cluster(strategy.new_state(), build_dataset(cfg, "train"))
    else:
        raise ValueError("Unknown EXPR_TYPE: %s" % cfg.EXPR_TYPE)
    if result and cfg.RESULTS:
        with storage.open_file(cfg.RESULTS, "w") as f:
            json.dump(result, f)
    return result


def run_experiment_eval(cfg, device=None) -> Dict:
    strategy = ActiveLearningStrategy(cfg, device)
    state = strategy.new_state()
    test_pool = build_dataset(cfg, "test")
    if cfg.EXPR_TYPE == "AL_EVAL":
        return strategy.run_al_eval(state, test_pool)
    return strategy.run_eval(state, test_pool)


def main(argv=None, device=None) -> Optional[FlowOutput]:
    """The CLI.  `device` (or ``--device``) picks the torch device; the
    default is the CUDA card.  Under torchrun it joins the other ranks
    first (``parallel.initialize_distributed``), and leaves the group at
    the end when it made it."""
    argparser = argparse.ArgumentParser()
    argparser.add_argument("--config_file", help="Path to experiment config file.", default="")
    argparser.add_argument("--device", default=None,
                           help="torch device to run on (default: the CUDA card; 'cpu' to run "
                                "the plain versions of the kernels on the CPU)")
    args = argparser.parse_args(argv)
    requested = args.device if args.device is not None else device
    # The group first: on a card it picks the rank's card, which the
    # device then resolves to.
    joined = parallel.active()
    owned = parallel.initialize_distributed(device=requested) and not joined
    device = resolve_device(requested)
    cfg = config_lib.get_default_configs()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    logger = get_logger("workflow")
    logger.info("Merged configuration from %s." % (args.config_file or "<defaults>"))
    logger.info("Experiment type: %s; device %s" % (cfg.EXPR_TYPE, device))
    # Every artifact path hangs off the timestamped EXPR_NAME.
    cfg.EXPR_NAME = cfg.EXPR_NAME + "-" + parallel.broadcast_string(
        "mval/expr_stamp", datetime.now().strftime("%m.%d.%Y:%H:%M.%f"))
    if not cfg.RESULTS:
        with tempfile.NamedTemporaryFile(delete=False, suffix=".json") as f:
            cfg.RESULTS = f.name
    logger.info("Results will be saved to %s" % cfg.RESULTS)
    result = run_experiment(cfg, device)
    if owned:  # a group this call made, the run's collectives done
        parallel.shutdown()
    if result:
        output = prepare_output(cfg, result)
        print(output)
        return output
    print("Experiment type %s does not have output." % cfg.EXPR_TYPE)
    return None


if __name__ == "__main__":
    main()
