"""Active-learning strategy of the port: training and evaluation, the pool
sweep, selection and SAL pseudo-labels.

The port's counterpart of the JAX package's strategy.py for the AL step
(reference: strategy.py:28-135, 868-1147): ``sample_next_batch`` draws the
first batch at random, then scores the whole unlabeled pool
(``_compute_sal_dict``: the FrameLoader's host decode feeding
``Engine.score_step``, K1 on every batch), selects by ``nlargest`` over the
AL metric or by the k-center coreset (K2's sweep), pseudo-labels frames for
SAL, and writes the guid logs (SAMPLED-GUID-ITER-n, SAL-GUID-ITER-n,
SAL-DICT-ITER-n) in the reference's JSON format.

Training (reference: strategy.py:240-546): ``run_fully_supervised_training``
and ``al_iteration`` run ``_train``, the JAX package's loop
(strategy.py:806-992 there): ``Engine.train_step`` on batches finished on the
device (``device_prepare``), skips summed on the device and read only at log
points, and at every TRAIN.LOG_EVERY_ITER (and at the end, when TOTAL_STEPS
is not a multiple of it) ``_evaluate_all`` (``eval_step``, K1 on every
batch), checkpoints ``CKPT-E<step>-MKPE<mkpe>`` and ``CKPT-FINAL``
(utils/checkpoint.py) and the metrics writer's records.

``state`` is an ``engine.TrainState`` (``new_state``, or what ``_train``
returns) or a reference-named torch state dict (``models.convert.
from_flax``'s output, or a checkpoint's); the engine's inference weights
follow it (``_load_state``).  One process does all of it; the multi-process
loop is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import OrderedDict, deque
from heapq import nlargest
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from . import engine as engine_mod
from .data import FrameLoader
from .data.pipeline import device_prepare
from .device import to_device
from .engine import Engine, TrainState
from .ops import coreset as coreset_ops
from .ops import image as image_ops
from .utils import RateLogger, evaluation, get_logger, prng, profiling, storage
from .utils import checkpoint as ckpt
from .utils.kmeans import KMeans
from .utils.metrics_writer import MetricsWriter


class ActiveLearningStrategy:
    def __init__(self, al_cfg, device: Optional[Union[str, torch.device]] = None):
        self._logger = get_logger(__name__)
        self.al_cfg = al_cfg
        self.engine = Engine(al_cfg, device)
        self.device = self.engine.device
        # Root joint for pose centering (reference: strategy.py:34-37).
        self.joint_root_index = 2 if al_cfg.DATA.TYPE != "ih26m" else 21
        self.al_writer = None  # metrics writer: not ported yet
        self._state = None  # the state dict the engine holds
        self.kmeans: Optional[KMeans] = None
        if al_cfg.EXPR_TYPE == "SAL" and al_cfg.SAL.CLUSTER_FILE_PATH:
            with storage.open_file(al_cfg.SAL.CLUSTER_FILE_PATH) as f:
                clusters = json.load(f)
            kp_values = []
            for guid in clusters:
                kp = np.asarray(clusters[guid], dtype=np.float64)
                if kp.ndim < 2:
                    # A LOSS-type dump ({guid: scalar}) cannot seed the pose
                    # KMeans; the reference fails with a bare IndexError.
                    raise ValueError(
                        "SAL.CLUSTER_FILE_PATH must hold per-guid 3D poses "
                        "(a POSE-type cluster dump); entry %r has shape %s. "
                        "LOSS-type cluster files are for analysis, not "
                        "KMeans seeding." % (guid, kp.shape)
                    )
                if kp.shape[0] != 3 and kp.shape[-1] >= 3:
                    kp = kp.T[:3]  # [K, >=3] -> [3, K]
                kp = kp[:3] - kp[:3, self.joint_root_index:self.joint_root_index + 1]
                kp_values.append(kp.flatten())
            self.kmeans = KMeans(al_cfg.SAL.NUM_CLUSTERS, random_state=al_cfg.RANDOM_SEED,
                                 device=self.device).fit(np.stack(kp_values))

    # ------------------------------------------------------------------ utils

    def _expr_dir(self, *sub) -> str:
        return storage.join(self.al_cfg.LOG_DIR, self.al_cfg.EXPR_NAME, *sub)

    def _rng(self, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng((int(self.al_cfg.RANDOM_SEED) + salt) & 0x7FFFFFFF)

    def _load_state(self, state) -> None:
        """The engine's inference weights follow `state`: a TrainState
        (refreshed after it trains), or a state dict (loaded when it is not
        the dict loaded last)."""
        if isinstance(state, TrainState):
            self.engine.use_state(state)
            self._state = None
        elif state is not None and state is not self._state:
            self.engine.load_state_dict(state)
            self._state = state

    def _get_loader(self, pool, batch_size: int, num_workers: Optional[int] = None) -> FrameLoader:
        """Loader factory (reference: strategy.py:747-760).  `num_workers`
        follows the reference's split: TRAIN.NUM_WORKERS by default,
        AL.INFERENCE.NUM_WORKERS for the scoring loaders; 0 decodes in this
        process."""
        if num_workers is None:
            num_workers = self.al_cfg.TRAIN.NUM_WORKERS
        return FrameLoader(pool, self.al_cfg.DATA, self.al_cfg.POSE_ESTIMATOR.STRIDE,
                           batch_size=batch_size, num_workers=num_workers)

    def _put(self, arr) -> torch.Tensor:
        return to_device(np.ascontiguousarray(arr), self.device)

    # Batches in flight in a sweep: enough queued to overlap host prep and
    # the copies with device compute, few enough to bound the device memory
    # held by batches not yet fetched.
    SWEEP_INFLIGHT_WINDOW = 4

    def _start_fetch(self, tree: Dict[str, torch.Tensor]):
        """Queue the copy of a batch's outputs to the host: pinned host
        tensors filled with ``non_blocking=True`` and an event after them on
        the card; (host tensors, event or None)."""
        if self.device.type != "cuda":
            return tree, None
        host = {}
        for name, value in tree.items():
            host[name] = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            host[name].copy_(value, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _pipelined_fetch(self, dispatched):
        """Bounded dispatch-ahead for the sweep loops.  `dispatched` yields
        one (meta, tree) a batch: `meta` passes through, `tree` holds the
        batch's device outputs.  Yields (meta, {name: numpy}) in order,
        waiting on a batch's copy only when SWEEP_INFLIGHT_WINDOW batches are
        in flight (a fetch inside the dispatch loop would serialize the next
        batch's host prep against the card)."""
        pending = deque()

        def finish(item):
            meta, host, event = item
            if event is not None:
                event.synchronize()
            return meta, {name: value.numpy() for name, value in host.items()}

        for meta, tree in dispatched:
            pending.append((meta,) + self._start_fetch(tree))
            if len(pending) >= self.SWEEP_INFLIGHT_WINDOW:
                yield finish(pending.popleft())
        while pending:
            yield finish(pending.popleft())

    def _device_images(self, batch: Dict) -> torch.Tensor:
        """batch["images"] on the device; under DATA.DEVICE_CROP the loader
        ships full frames and the square-box crop + bilinear resize runs
        there (ops/image.py::crop_resize_uint8).  Either way the engine sees
        [B, V, INPUT_H, INPUT_W, 3] uint8."""
        images = self._put(batch["images"])
        if self.al_cfg.DATA.DEVICE_CROP:
            images = image_ops.crop_resize_uint8(images, self._put(batch["square_box"]),
                                                 self.al_cfg.DATA.INPUT_HEIGHT,
                                                 self.al_cfg.DATA.INPUT_WIDTH)
        return images

    def _device_batch(self, batch: Dict, train: bool):
        """A host batch -> (normalized float32 images, GT heatmaps) on the
        device."""
        d = self.al_cfg.DATA
        return device_prepare(self._device_images(batch), self._put(batch["2d_keypoints"]),
                              self._put(batch["sigma"]), stride=self.al_cfg.POSE_ESTIMATOR.STRIDE,
                              train=train, num_aug=d.NUM_AUG if train else 0)

    def new_state(self, salt: int = 0) -> TrainState:
        """A freshly initialized TrainState from RANDOM_SEED + salt."""
        seed = (int(self.al_cfg.RANDOM_SEED) + salt) & 0x7FFFFFFF
        return self.engine.init_state(torch.Generator().manual_seed(seed))

    # ----------------------------------------------------------- AL sampling

    def sample_next_batch(self, train_pool, al_num_frames, sal_num_frames, state, iteration):
        """Reference: strategy.py:54-135."""
        if iteration == 0:
            self._logger.info("%s strategy, randomly sampling the initial batch."
                              % self.al_cfg.AL.STRATEGY)
            al_guids = self._random_sample_frames(train_pool, al_num_frames)
        else:
            self._logger.info("%s strategy sampling %d frames."
                              % (self.al_cfg.AL.STRATEGY, al_num_frames))
            al_guids, sal_guids, sal_dict = self._sal_pseudo_labeling(
                train_pool, al_num_frames, sal_num_frames, state, iteration)
            if sal_dict:
                if sal_guids:
                    with storage.open_file(self._expr_dir("SAL-GUID-ITER-%d" % iteration),
                                           "w") as f:
                        f.write(json.dumps(sal_guids))
                with storage.open_file(self._expr_dir("SAL-DICT-ITER-%d" % iteration), "w") as f:
                    f.write(json.dumps(sal_dict))
        storage.makedirs(self._expr_dir())
        with storage.open_file(self._expr_dir("SAMPLED-GUID-ITER-%d" % iteration), "w") as f:
            f.write(json.dumps(al_guids))
        return train_pool

    def _random_sample_frames(self, pool, num_frames: int, salt: int = 0) -> List[str]:
        """Reference: strategy.py:868-878.  A request larger than the
        unlabeled pool takes the whole pool with a warning, as `nlargest`
        truncates (the reference crashes inside random.sample)."""
        rng = self._rng(salt)
        guids = list(pool.unlabeled_data.keys())
        if num_frames > len(guids):
            self._logger.warning(
                "Random sampling requested %d frames but only %d remain "
                "unlabeled; selecting all of them." % (num_frames, len(guids)))
            num_frames = len(guids)
        idx = rng.choice(len(guids), size=num_frames, replace=False)
        picked = [guids[i] for i in idx]
        pool.label_by_frame_guids(picked)
        return picked

    def _sal_pseudo_labeling(self, train_pool, al_num_frames, pseudo_num_frames, state,
                             iteration):
        """Scoring + selection + pseudo-labeling (reference:
        strategy.py:915-1002)."""
        cfg = self.al_cfg
        if cfg.AL.STRATEGY == "RANDOM" and cfg.EXPR_TYPE == "AL":
            # No inference needed (reference: strategy.py:918-923).
            al_guids = self._random_sample_frames(train_pool, al_num_frames, salt=iteration)
            return al_guids, [], {}

        train_pool.resample_unlabeled_data()
        sal_dict = self._compute_sal_dict(train_pool, state, iteration)
        al_metric_dict = {guid: v for guid, v in sal_dict["al_metric"].items()
                          if not math.isnan(v)}
        if cfg.AL.STRATEGY == "CORESET":
            # Frames with a non-finite FEATURE row are dropped, in the space
            # k-center runs in: a NaN row would win every argmax and poison
            # the min distances (the reference's sklearn rejects NaN).
            # POSE features are the triangulated keypoints; EMBEDDING
            # features the pooled trunk embedding (a frame whose
            # triangulation diverged keeps a finite embedding).
            use_embedding = cfg.AL.CORESET_FEATURES == "EMBEDDING"
            # Default {}: an exhausted pool scores no batch and has no key.
            cand_emb = sal_dict.pop("embedding", {}) if use_embedding else {}
            if use_embedding:
                coreset_candidates = OrderedDict(
                    (guid, kp) for guid, kp in sal_dict["pred_3d_keypoints"].items()
                    if guid in cand_emb and np.isfinite(cand_emb[guid]).all())
            else:
                coreset_candidates = OrderedDict(
                    (guid, kp) for guid, kp in sal_dict["pred_3d_keypoints"].items()
                    if np.isfinite(kp).all())
            dropped = len(sal_dict["pred_3d_keypoints"]) - len(coreset_candidates)
            if dropped:
                self._logger.warning(
                    "CORESET: dropped %d frames with non-finite %s from the candidate pool."
                    % (dropped, "embeddings" if use_embedding else "triangulated keypoints"))
            features = None
            al_dict = train_pool.get_al_dict_for_coreset()
            if use_embedding:
                # The labeled set's embeddings come from one more (small)
                # sweep; its non-finite rows leave the center set, and
                # al_dict with them so CoreSet's row count holds.
                lab_emb = self._embed_labeled(train_pool, state)
                lab_idx = [i for i, f in enumerate(train_pool.labeled_data)
                           if np.isfinite(lab_emb[f["guid"]]).all()]
                if len(lab_idx) != len(train_pool.labeled_data):
                    self._logger.warning(
                        "CORESET: dropped %d labeled frames with non-finite embeddings from "
                        "the center set." % (len(train_pool.labeled_data) - len(lab_idx)))
                al_dict = OrderedDict((i, al_dict[i]) for i in lab_idx)
                features = np.stack(
                    [cand_emb[g] for g in coreset_candidates]
                    + [lab_emb[train_pool.labeled_data[i]["guid"]] for i in lab_idx])
            cs = coreset_ops.CoreSet(coreset_candidates, al_dict, self.joint_root_index,
                                     device=self.device, features=features)
            al_guids = cs.select_batch(min(al_num_frames, len(coreset_candidates)))
        else:
            al_guids = nlargest(al_num_frames, al_metric_dict, key=al_metric_dict.get)
        train_pool.label_by_frame_guids(al_guids)

        sal_sampled_guids: List[str] = []
        if cfg.EXPR_TYPE == "SAL":
            # Filters (reference: strategy.py:952-967): not AL-selected,
            # finite, not already pseudo-labeled, enough RANSAC inliers.
            al_set = set(al_guids)
            already = set(train_pool.pseudo_label_guids)
            sal_metric_dict = {
                guid: v for guid, v in sal_dict["sal_metric"].items()
                if (guid not in al_set and not math.isnan(v) and guid not in already
                    and sal_dict["inlier_count"][guid] > cfg.SAL.INLIER_THRESHOLD)
            }
            sal_guids = sorted(sal_metric_dict, key=sal_metric_dict.get)
            if cfg.SAL.CLUSTER_FILE_PATH:
                self._logger.info("Pseudo-labeling frames by %d clusters." % cfg.SAL.NUM_CLUSTERS)
                counter = [0] * cfg.SAL.NUM_CLUSTERS
                per_cluster = pseudo_num_frames // cfg.SAL.NUM_CLUSTERS
                if sal_guids:
                    # One batched cluster assignment for every candidate (the
                    # reference predicts guid by guid, strategy.py:973-991);
                    # the quota walk stays on the host.
                    feats = np.stack([
                        np.asarray(sal_dict["pred_3d_keypoints"][g], dtype=np.float64).T
                        for g in sal_guids
                    ])  # [N, 3, K]
                    feats = feats - feats[:, :, self.joint_root_index:self.joint_root_index + 1]
                    cluster_ids = self.kmeans.predict(feats.reshape(len(sal_guids), -1))
                    for guid, cluster_id in zip(sal_guids, cluster_ids):
                        if counter[int(cluster_id)] < per_cluster:
                            counter[int(cluster_id)] += 1
                            sal_sampled_guids.append(guid)
            elif sal_guids and pseudo_num_frames > 0:
                head = sal_guids[:2 * pseudo_num_frames]
                take = min(pseudo_num_frames, len(head))
                idx = self._rng(iteration).choice(len(head), size=take, replace=False)
                sal_sampled_guids = [head[i] for i in idx]
            self._logger.info("Pseudo-labeling %d frames." % len(sal_sampled_guids))
            if sal_sampled_guids:
                train_pool.pseudo_label_by_frame_guids(sal_sampled_guids,
                                                       sal_dict["pred_3d_keypoints"])
        return al_guids, sal_sampled_guids, sal_dict

    def _compute_sal_dict(self, pool, state, iteration: int = 0) -> Dict:
        """Score the whole unlabeled pool (reference: strategy.py:1004-1147):
        one score_step a fixed-shape batch, the host keying the results by
        guid.  The first batch calibrates the int8 backbone when it is on."""
        cfg = self.al_cfg
        self._load_state(state)
        sal_dict = {
            "al_metric": OrderedDict(),
            "sal_metric": OrderedDict(),
            "inlier_count": OrderedDict(),
            "pred_3d_keypoints": OrderedDict(),
            "mkpe": OrderedDict(),
        }
        loader = self._get_loader(pool, cfg.AL.INFERENCE.BATCH_SIZE, cfg.AL.INFERENCE.NUM_WORKERS)
        num_views = pool.get_num_view_per_frame()
        pairs = self._put(self.engine.pairs(num_views))
        key = prng.PRNGKey((int(cfg.RANDOM_SEED) + 7919 * (iteration + 1)) & 0x7FFFFFFF)
        t0 = time.time()
        n_frames = 0
        int8_scales = None
        progress = RateLogger(self._logger, "scored", len(pool.data) if pool.data else 0)
        if self.engine.use_int8:
            if cfg.AL.STRATEGY in engine_mod.INT8_SAFE_STRATEGIES:
                self._logger.info(
                    "Pool scoring uses the int8 backbone (TPU.INT8_SCORING default, %s "
                    "measured int8-safe in the JAX package; set TPU.INT8_SCORING: false for "
                    "float scoring)." % cfg.AL.STRATEGY)
            elif cfg.AL.STRATEGY in engine_mod.INT8_MIXED_TAIL:
                self._logger.info(
                    "Pool scoring uses the MIXED int8 backbone (%d float tail stage(s); %s "
                    "measured ranking-safe only with the float tail; set "
                    "TPU.INT8_SCORING: false for float scoring)."
                    % (self.engine.int8_float_tail, cfg.AL.STRATEGY))
            else:
                self._logger.warning(
                    "TPU.INT8_SCORING_FORCE overrides the per-strategy gate: %s measured "
                    "int8-UNSAFE for selection; rankings may differ from float."
                    % cfg.AL.STRATEGY)

        def _dispatched():
            nonlocal key, int8_scales
            for batch in loader:
                key, skey = prng.split(key)
                images = self._device_images(batch)
                if int8_scales is None:
                    # One-batch activation calibration (None when the int8
                    # backbone is off).
                    int8_scales = self.engine.int8_calibrate(images)
                out = self.engine.score_step(
                    images,
                    self._put(batch["proj_matrices"]),
                    self._put(batch["joint_valid"]),
                    pairs,
                    self._put(batch["3d_keypoints"]),
                    al_strategy=cfg.AL.STRATEGY,
                    key=skey,
                    int8_scales=int8_scales,
                    mpe_aggregate=cfg.AL.MPE_CONFIG,
                    hp_aggregate=cfg.AL.HP_CONFIG,
                    bsb_aggregate=cfg.AL.BSB_CONFIG,
                )
                yield (batch["guid"], batch["frame_valid"]), out

        try:
            for (guids, frame_valid), out in self._pipelined_fetch(_dispatched()):
                for i, guid in enumerate(guids):
                    if not frame_valid[i]:
                        continue
                    sal_dict["sal_metric"][guid] = float(out["sal_metric"][i])
                    sal_dict["inlier_count"][guid] = float(out["inlier_count"][i])
                    sal_dict["pred_3d_keypoints"][guid] = out["keypoints_3d"][i].tolist()
                    sal_dict["al_metric"][guid] = float(out["al_metric"][i])
                    sal_dict["mkpe"][guid] = float(out["mkpe"][i])
                    if "embedding" in out:
                        # CORESET with EMBEDDING features; popped before the
                        # sal_dict is written out.
                        sal_dict.setdefault("embedding", OrderedDict())[guid] = np.asarray(
                            out["embedding"][i], np.float32)
                    n_frames += 1
                progress.tick(int(np.sum(frame_valid)))
        finally:
            loader.close()  # releases the decode pool's liveness ref
        dt = time.time() - t0
        if n_frames:
            self._logger.info("Scored %d frames x %d views in %.2fs (%.2f frames/s)."
                              % (n_frames, num_views, dt, n_frames / dt))
        return sal_dict

    def _embed_labeled(self, train_pool, state) -> "OrderedDict[str, np.ndarray]":
        """Pooled trunk embeddings of the LABELED set, keyed by guid: the
        centers already covered, for AL.CORESET_FEATURES=EMBEDDING.  One
        embed_step sweep over train_pool.labeled_data."""

        class _ListPool:
            def __init__(self, frames):
                self.data = frames

        self._load_state(state)
        loader = self._get_loader(_ListPool(list(train_pool.labeled_data)),
                                  self.al_cfg.AL.INFERENCE.BATCH_SIZE,
                                  self.al_cfg.AL.INFERENCE.NUM_WORKERS)
        embeddings: "OrderedDict[str, np.ndarray]" = OrderedDict()

        def _dispatched():
            for batch in loader:
                emb = self.engine.embed_step(self._device_images(batch))
                yield (batch["guid"], batch["frame_valid"]), {"embedding": emb}

        try:
            for (guids, frame_valid), out in self._pipelined_fetch(_dispatched()):
                for i, guid in enumerate(guids):
                    if frame_valid[i]:
                        embeddings[guid] = np.asarray(out["embedding"][i], np.float32)
        finally:
            loader.close()
        return embeddings

    # -------------------------------------------------------------- training

    def al_iteration(self, state, train_pool, val_pool, iteration):
        """Reference: strategy.py:240-265."""
        train_cfg = self.al_cfg.clone()
        train_cfg.EXPR_NAME = train_cfg.EXPR_NAME + "/ITER-%d" % iteration
        return self._train(iteration, train_cfg, train_pool, val_pool, state)

    def run_fully_supervised_training(self, state, train_pool, val_pool):
        """Reference: strategy.py:279-313."""
        if self.al_cfg.TRAIN.FULLY_SUPERVISED_FRAME_COUNT != -1:
            self._random_sample_frames(train_pool, self.al_cfg.TRAIN.FULLY_SUPERVISED_FRAME_COUNT)
        else:
            train_pool.label_all()
        train_cfg = self.al_cfg.clone()
        train_cfg.EXPR_NAME = train_cfg.EXPR_NAME + "/FULLY_SUPERVISED"
        return self._train(-1, train_cfg, train_pool, val_pool, state)

    def _prepare_experiment(self, cfg):
        """Reference: strategy.py:651-679.  (checkpoints dir, writer)."""
        experiment_dir = storage.join(cfg.LOG_DIR, cfg.EXPR_NAME)
        checkpoints_dir = storage.join(experiment_dir, "checkpoints")
        storage.makedirs(checkpoints_dir)
        with storage.open_file(storage.join(experiment_dir, "config.yaml"), "w") as f:
            f.write(cfg.dump())
        return checkpoints_dir, MetricsWriter(storage.join(experiment_dir, "summary"))

    def _load_weights(self, cfg, state: TrainState) -> TrainState:
        """TRAIN.RESTORE_FROM, a true resume (weights, BN statistics, Adam
        state and step, which the reference saves and never restores), or
        TRAIN.INIT_WEIGHT, the reference's filtered pretrained init
        (reference: strategy.py:713-745)."""
        if cfg.TRAIN.RESTORE_FROM:
            self._logger.info("Resuming from %s" % cfg.TRAIN.RESTORE_FROM)
            return ckpt.restore_checkpoint(cfg.TRAIN.RESTORE_FROM, state)
        if cfg.TRAIN.INIT_WEIGHT:
            self._logger.info("Initializing weights from %s" % cfg.TRAIN.INIT_WEIGHT)
            return ckpt.load_pretrained(cfg, cfg.TRAIN.INIT_WEIGHT, state)
        self._logger.info("Training from scratch.")
        return state

    def _save_point(self, checkpoints_dir, state, epoch, step, mkpe, lr=None) -> None:
        """The step-named checkpoint and the rolling CKPT-FINAL.  One process
        writes and reads them, so the JAX package's barrier after a save
        has nobody to wait for (multi-process runs: ROADMAP A9)."""
        ckpt.save_checkpoints(
            [os.path.join(checkpoints_dir, "CKPT-E%d-MKPE%.2f" % (step, mkpe)),
             os.path.join(checkpoints_dir, "CKPT-FINAL")], state, epoch, lr)

    def _train(self, iteration_idx, train_cfg, train_pool, val_pool, state):
        """The training loop (reference: strategy.py:422-546; JAX
        strategy.py:806-992).  Returns the trained state."""
        checkpoints_dir, writer = self._prepare_experiment(train_cfg)
        val_pool.label_all()
        val_pool.resample_frames(min(train_cfg.TRAIN.VAL_SIZE, len(val_pool.labeled_data)),
                                 rng=self._rng(1))
        val_loader = self._get_loader(val_pool, train_cfg.TRAIN.BATCH_SIZE)
        state = self._load_weights(train_cfg, state)
        train_pool.resample_frames(-1, train_cfg.DATA.EPOCH_SIZE,
                                   rng=self._rng(2 + max(iteration_idx, 0)))
        train_loader = self._get_loader(train_pool, train_cfg.TRAIN.BATCH_SIZE)
        log_every = train_cfg.TRAIN.LOG_EVERY_ITER
        try:
            total_steps = max(train_cfg.TRAIN.OPTIM.TOTAL_STEPS, log_every)
            epoch, global_step = 0, int(state.step)
            if global_step:
                self._logger.info("Resuming training at step %d." % global_step)
            # Skips are summed on the device and read at log points only: a
            # per-step fetch would make every step wait for the card.
            skip_sum = torch.zeros((), dtype=torch.int64, device=self.device)
            t_start, steps_timed = time.time(), 0
            step_timer = profiling.StepTimer()
            while global_step < total_steps:
                epoch += 1
                batches_this_epoch = 0
                for batch in train_loader:
                    batches_this_epoch += 1
                    images, gt_heat = self._device_batch(batch, train=True)
                    state, metrics = self.engine.train_step(
                        state, images, gt_heat, self._put(batch["per_view_joint_valid"]),
                        self._put(batch["frame_valid"]))
                    global_step += 1
                    steps_timed += 1
                    step_timer.tick()
                    skip_sum = skip_sum + metrics["skipped"]
                    if global_step % log_every == 0:
                        # The training window's rate, before the log point's work.
                        steps_per_sec = steps_timed / max(time.time() - t_start, 1e-9)
                        last_loss = float(metrics["loss"])
                        lr = float(metrics["lr"])
                        skips = int(skip_sum)
                        if skips:
                            self._logger.warning(
                                "%d steps skipped so far (non-finite or clipped loss)." % skips)
                        eval_results = self._evaluate_all(iteration_idx, state, val_loader)
                        self._save_point(checkpoints_dir, state, epoch, global_step,
                                         eval_results["mkpe"], lr)
                        writer.add_scalar("lr", lr, global_step)
                        writer.add_scalar("3D MKPE", eval_results["mkpe"], global_step)
                        writer.add_scalar("loss/train", last_loss, global_step)
                        writer.add_pck_curves("3DPCK", global_step, eval_results["thresholds"],
                                              eval_results["pcks"])
                        if "pckh_thresholds" in eval_results:
                            writer.add_pck_curves("3DPCKH", global_step,
                                                  eval_results["pckh_thresholds"],
                                                  eval_results["pckh_pcks"])
                        writer.add_scalar("steps_per_sec", steps_per_sec, global_step)
                        self._log_train_figures(writer, metrics["first_heatmap"], images, gt_heat,
                                                global_step)
                        for k, v in step_timer.summary().items():
                            writer.add_scalar("perf/%s" % k, v, global_step)
                        for dev, stats in profiling.device_memory_stats().items():
                            writer.add_scalar("hbm/%s/bytes_in_use_gib" % dev,
                                              stats["bytes_in_use_gib"], global_step)
                        self._logger.info(
                            "[EPOCH %d][STEP %d] loss %.4f mkpe %.2f (%.2f steps/s)"
                            % (epoch, global_step, last_loss, eval_results["mkpe"], steps_per_sec))
                        t_start, steps_timed = time.time(), 0
                    if global_step >= total_steps:
                        break
                if batches_this_epoch == 0:
                    raise RuntimeError(
                        "Train loader yielded no batches (labeled pool size %d, batch size %d) — "
                        "training cannot make progress."
                        % (len(train_pool.labeled_data), train_cfg.TRAIN.BATCH_SIZE))
            if global_step % log_every:
                # TOTAL_STEPS is not a multiple of LOG_EVERY_ITER: the
                # reference saves at log points only and so drops the last
                # steps from CKPT-FINAL, which the next AL iteration reads;
                # the end of training is saved here instead.
                eval_results = self._evaluate_all(iteration_idx, state, val_loader)
                self._save_point(checkpoints_dir, state, epoch, global_step, eval_results["mkpe"])
                writer.add_scalar("3D MKPE", eval_results["mkpe"], global_step)
                self._logger.info("[FINAL][STEP %d] mkpe %.2f — end-of-training checkpoint saved."
                                  % (global_step, eval_results["mkpe"]))
        finally:
            train_loader.close()  # the decode pool's references, also on a failure
            val_loader.close()
        writer.close()
        return state

    def _log_train_figures(self, writer, first_heatmap, images, gt_heat, step):
        """The predicted against the GT heatmaps and a 2D keypoint overlay of
        the first crop of the batch (reference: utils/visualization.py:14-64),
        from the prediction the train step already made."""
        from .ops import geometry as geo_ops
        from .ops import heatmap as heatmap_ops
        from .utils import visualization

        pred_hm = first_heatmap.detach().to("cpu", torch.float32)  # [K, h, w]
        gt_hm = gt_heat[0, 0].detach().to("cpu", torch.float32)
        writer.add_image("train/pred_vs_gt_heatmaps",
                         visualization.pred_vs_gt_heatmaps(pred_hm.numpy(), gt_hm.numpy()), step)
        img = images[0, 0].detach().cpu().numpy()
        if img.dtype != np.uint8:
            img = geo_ops.denormalize_image(img.astype(np.float32))
        stride = float(self.al_cfg.POSE_ESTIMATOR.STRIDE)
        pred_kp = heatmap_ops.decode_argmax(pred_hm, stride=stride)[0].numpy()
        gt_kp = heatmap_ops.decode_argmax(gt_hm, stride=stride)[0].numpy()
        writer.add_image("train/keypoints_2d",
                         visualization.overlay_keypoints(img, pred_kp, gt_keypoints_2d=gt_kp), step)

    # ------------------------------------------------------------- evaluation

    def _evaluate_all(self, iteration_idx, state, val_loader) -> Dict:
        """3D MKPE and PCK (and PCKh) over the validation loader (reference:
        strategy.py:584-649): eval_step a batch (K1 decodes its heatmaps),
        the metrics on the host."""
        self._load_state(state)
        pairs = self._put(self.engine.pairs(val_loader.pool.get_num_view_per_frame()))
        int8_scales = None

        def _dispatched():
            nonlocal int8_scales
            for batch in val_loader:
                images = self._device_images(batch)
                if int8_scales is None:
                    int8_scales = self.engine.int8_calibrate(images, for_eval=True)
                out = self.engine.eval_step(images, self._put(batch["proj_matrices"]),
                                            self._put(batch["joint_valid"]), pairs,
                                            int8_scales=int8_scales)
                yield (batch["frame_valid"], batch["3d_keypoints"], batch["joint_valid"]), out

        preds, gts, valids = [], [], []
        for (mask, kp3d_gt, joint_valid), out in self._pipelined_fetch(_dispatched()):
            mask = np.asarray(mask, bool)
            preds.append(out["keypoints_3d"][mask])
            gts.append(np.asarray(kp3d_gt)[mask])
            valids.append(np.asarray(joint_valid)[mask].astype(np.float32))
        pred, gt, valid = np.concatenate(preds), np.concatenate(gts), np.concatenate(valids)
        thresholds, pcks = evaluation.compute_3d_pck_figure(pred, gt, valid)
        results = {"mkpe": float(evaluation.compute_mkpe(pred, gt, valid)),
                   "thresholds": list(thresholds), "pcks": pcks}
        if self.al_cfg.DATA.TYPE != "ih26m":
            pckh_thresholds, pckh_pcks = evaluation.compute_3d_pckh_figure(pred, gt)
            results["pckh_thresholds"] = list(pckh_thresholds)
            results["pckh_pcks"] = pckh_pcks
        return results
