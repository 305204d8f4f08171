"""Active-learning strategy of the port: training and evaluation, the pool
sweep, selection and SAL pseudo-labels.

The port's counterpart of the JAX package's strategy.py for the AL step
(reference: strategy.py:28-135, 868-1147): ``sample_next_batch`` draws the
first batch at random, then scores the whole unlabeled pool
(``_compute_sal_dict``: the FrameLoader's host decode feeding
``Engine.score_step``, K1 on every batch), selects by ``nlargest`` over the
AL metric or by the k-center coreset (K2's sweep), pseudo-labels frames for
SAL, and writes the guid logs (SAMPLED-GUID-ITER-n, SAL-GUID-ITER-n,
SAL-DICT-ITER-n) in the reference's JSON format; the AL writer
(``prepare_al_experiments``) records the sal/* histograms of each step and
the sweep's frames/s.

Training (reference: strategy.py:240-546): ``run_fully_supervised_training``
and ``al_iteration`` run ``_train``, the JAX package's loop
(strategy.py:806-992 there): ``Engine.train_step`` on batches finished on the
device (``device_prepare``), skips summed on the device and read only at log
points, and at every TRAIN.LOG_EVERY_ITER (and at the end, when TOTAL_STEPS
is not a multiple of it) ``_evaluate_all`` (``eval_step``, K1 on every
batch), checkpoints ``CKPT-E<step>-MKPE<mkpe>`` and ``CKPT-FINAL``
(utils/checkpoint.py) and the metrics writer's records.

Both loops mark their host work with ``utils.profiling`` spans (``sweep``,
``sweep.loader_wait`` / ``prepare`` / ``int8_calibrate`` / ``dispatch`` /
``collect``, ``fetch_wait``; ``train``, ``train.loader_wait`` / ``prepare``
/ ``step`` / ``log_point`` / ``records``, ``evaluate``, ``checkpoint``),
which record only under a ``torch.profiler`` session.

``state`` is an ``engine.TrainState`` (``new_state``, or what ``_train``
returns) or a reference-named torch state dict (``models.convert.
from_flax``'s output, or a checkpoint's); the engine's inference weights
follow it (``_load_state``).

Evaluation and the other experiment types (reference: strategy.py:137-238;
JAX strategy.py:1091-1316): ``run_eval`` and ``run_al_eval`` evaluate
checkpoints on the test split, ``evaluate_2d_pckh`` decodes crop-space 2D
keypoints through K1, ``cluster`` dumps per-frame poses or losses, and
``restore_dataset`` / ``_copy_previous_checkpoints`` resume an AL run from
its guid logs and checkpoints.  workflow.py drives them.

Under a process group (``parallel``, one process a card; JAX
strategy.py:102-224) every loader reads its data row's shard of the pool
(``pool[row::data]``, batch counts equalized), so a global batch is
``BATCH_SIZE x data`` frames, data row d's rows at ``d * B ..``; under view
sharding the ranks of a data row load the same frames, each decoding its
block of their views (``parallel.view_slice``; the camera arrays keep
every view).  A sweep's outputs, the same on every rank of a data row, are
all-gathered over the data group, one collective a batch
(``_fetch_global``), and keyed by ``FrameLoader.global_batch_layout``:
every rank holds the whole sal_dict and selects the same frames. Rank 0
alone writes the guid logs, SAL-DICT, checkpoints, configs and records; a
barrier follows every checkpoint save, so no rank reads one before it is
whole.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import OrderedDict, deque
from heapq import nlargest
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import engine as engine_mod
from . import parallel
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
        self.num_joints = al_cfg.DATA.NUM_JOINTS
        self.joint_root_index = 2 if al_cfg.DATA.TYPE != "ih26m" else 21
        # The experiment's AL writer (sal/* histograms, the sweep's rate):
        # prepare_al_experiments or the workflow attaches it.
        self.al_writer: Optional[MetricsWriter] = None
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
        process.  `batch_size` is per data row, as the reference's per-GPU
        DDP batch: each data row loads its shard, so the global batch is
        `batch_size` x data, and each rank decodes its view column's views."""
        if num_workers is None:
            num_workers = self.al_cfg.TRAIN.NUM_WORKERS
        mesh = parallel.current_mesh()
        return FrameLoader(pool, self.al_cfg.DATA, self.al_cfg.POSE_ESTIMATOR.STRIDE,
                           batch_size=batch_size, num_shards=mesh.data,
                           shard_index=parallel.data_index(), num_workers=num_workers,
                           view_shard=(mesh.view, parallel.view_index()))

    @staticmethod
    def _views(batch: Dict) -> Tuple[int, slice]:
        """(the frames' view count, this rank's views of them): the loader
        decodes those views' images; the camera arrays hold all of them."""
        num_views = batch["proj_matrices"].shape[1]
        return num_views, parallel.view_slice(num_views)

    def _put(self, arr) -> torch.Tensor:
        """A host array of this rank's rows on the device.  Under more than
        one process it must have a batch dimension, or it could not be a
        share of a global batch (JAX raises there too, :192-199)."""
        arr = np.ascontiguousarray(arr)
        if arr.ndim == 0 and parallel.process_count() > 1:
            raise ValueError("a 0-d array cannot be this rank's rows of a global batch")
        return to_device(arr, self.device)

    def _fetch_global(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A batch's outputs for the global batch, on every rank (JAX
        :212-224; the reference's sal_dict all_gather, strategy.py:1090-1147):
        each leaf is every data row's rows concatenated in row order, global
        row ``d * B + i`` being data row d's row i (the order of
        ``FrameLoader.global_batch_layout``), gathered over the data group:
        the ranks of a data row hold the same outputs.  The leaves travel
        packed in one byte buffer, one collective a batch; under NCCL it is
        ordered on the stream and the host does not wait (gloo waits).  The
        identity without a process group and with one data row of views."""
        group = parallel.data_group()
        if not parallel.active() or (group is not None and len(group.ranks) == 1):
            return tree
        flat = [value.contiguous().reshape(-1).view(torch.uint8) for value in tree.values()]
        gathered = parallel.all_gather_rows(torch.cat(flat)[None], group)  # [data, bytes]
        out, offset = {}, 0
        for (name, value), part in zip(tree.items(), flat):
            piece = gathered[:, offset:offset + part.numel()].contiguous().view(value.dtype)
            out[name] = piece.reshape((-1,) + tuple(value.shape[1:]))
            offset += part.numel()
        return out

    @staticmethod
    def _batch_keys(loader: FrameLoader, index: int, batch: Dict):
        """(guids, frame_valid) of the global batch `index`: the local
        batch's with one data row, every shard's with more."""
        if loader.num_shards > 1:
            return loader.global_batch_layout(index)
        return batch["guid"], batch["frame_valid"]

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
        batch's device outputs (gathered over the ranks, `_fetch_global`).
        Yields (meta, {name: numpy}) in order, waiting on a batch's copy
        only when SWEEP_INFLIGHT_WINDOW batches are in flight (a fetch inside
        the dispatch loop would serialize the next batch's host prep against
        the card).  Every rank dispatches the same batches in the same
        order (the loaders' batch counts are equalized), so the collectives
        pair up."""
        pending = deque()

        def finish(item):
            meta, host, event = item
            with profiling.span("fetch_wait"):
                if event is not None:
                    profiling.wait(event)
            return meta, {name: value.numpy() for name, value in host.items()}

        for meta, tree in dispatched:
            pending.append((meta,) + self._start_fetch(self._fetch_global(tree)))
            if len(pending) >= self.SWEEP_INFLIGHT_WINDOW:
                yield finish(pending.popleft())
        while pending:
            yield finish(pending.popleft())

    def _device_images(self, batch: Dict) -> torch.Tensor:
        """batch["images"] on the device; under DATA.DEVICE_CROP the loader
        ships full frames and the square-box crop + bilinear resize runs
        there (ops/image.py::crop_resize_uint8).  Either way the engine sees
        [B, V, INPUT_H, INPUT_W, 3] uint8 (this rank's views)."""
        images = self._put(batch["images"])
        if self.al_cfg.DATA.DEVICE_CROP:
            _, views = self._views(batch)
            images = image_ops.crop_resize_uint8(images, self._put(batch["square_box"][:, views]),
                                                 self.al_cfg.DATA.INPUT_HEIGHT,
                                                 self.al_cfg.DATA.INPUT_WIDTH)
        return images

    def _device_batch(self, batch: Dict, train: bool, key: Optional[np.ndarray] = None):
        """A host batch -> (normalized float32 images, GT heatmaps) on the
        device; a training batch is augmented under DATA.NUM_AUG from the
        threefry `key` (JAX strategy.py:286-301)."""
        d = self.al_cfg.DATA
        num_views, views = self._views(batch)
        return device_prepare(self._device_images(batch),
                              self._put(batch["2d_keypoints"][:, views]),
                              self._put(batch["sigma"]), key,
                              stride=self.al_cfg.POSE_ESTIMATOR.STRIDE, train=train,
                              num_aug=d.NUM_AUG if train else 0, magnitude=d.AUG_MAGNITUDE,
                              use_rotation=d.USE_ROTATION, use_image_aug=d.USE_IMAGE_AUG,
                              const_magnitude=d.USE_CONST_AUG_MAGNITUDE, num_views=num_views)

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
            if sal_dict and parallel.is_main():
                if self.al_writer is not None:
                    self._write_sal_records(al_guids, sal_guids, sal_dict, iteration)
                if sal_guids:
                    with storage.open_file(self._expr_dir("SAL-GUID-ITER-%d" % iteration),
                                           "w") as f:
                        f.write(json.dumps(sal_guids))
                with storage.open_file(self._expr_dir("SAL-DICT-ITER-%d" % iteration), "w") as f:
                    f.write(json.dumps(sal_dict))
        if parallel.is_main():
            storage.makedirs(self._expr_dir())
            with storage.open_file(self._expr_dir("SAMPLED-GUID-ITER-%d" % iteration), "w") as f:
                f.write(json.dumps(al_guids))
        return train_pool

    def _write_sal_records(self, al_guids, sal_guids, sal_dict, iteration) -> None:
        """The AL writer's sal/* records of a step (JAX strategy.py:342-370):
        histograms of the pseudo-labeled frames' MKPE, inlier counts and SAL
        metric and of the selected frames' AL metric, and both counts.  A
        writer failure is logged, as the reference does."""
        try:
            if sal_guids:
                for tag, src in (("sal/mkpe", "mkpe"), ("sal/inlier_count", "inlier_count"),
                                 ("sal/sal_metric", "sal_metric")):
                    self.al_writer.add_histogram(tag, [sal_dict[src][g] for g in sal_guids],
                                                 iteration)
            self.al_writer.add_histogram(
                "sal/al_metric",
                [sal_dict["al_metric"][g] for g in al_guids if g in sal_dict["al_metric"]],
                iteration)
            self.al_writer.add_scalar("sal/al_num_frames", len(al_guids), iteration)
            self.al_writer.add_scalar("sal/sal_num_frames", len(sal_guids), iteration)
        except Exception as ex:
            self._logger.warning("Metrics writer error: %s" % ex)

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

    @profiling.spanned("sweep")
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
            for index, batch in enumerate(profiling.span_each("sweep.loader_wait", loader)):
                key, skey = prng.split(key)
                with profiling.span("sweep.prepare"):
                    images = self._device_images(batch)
                    proj = self._put(batch["proj_matrices"])
                    valid = self._put(batch["joint_valid"])
                    gt = self._put(batch["3d_keypoints"])
                if int8_scales is None:
                    # One-batch activation calibration (None when the int8
                    # backbone is off).
                    with profiling.span("sweep.int8_calibrate"):
                        int8_scales = self.engine.int8_calibrate(images)
                with profiling.span("sweep.dispatch"):
                    out = self.engine.score_step(
                        images,
                        proj,
                        valid,
                        pairs,
                        gt,
                        al_strategy=cfg.AL.STRATEGY,
                        key=skey,
                        int8_scales=int8_scales,
                        mpe_aggregate=cfg.AL.MPE_CONFIG,
                        hp_aggregate=cfg.AL.HP_CONFIG,
                        bsb_aggregate=cfg.AL.BSB_CONFIG,
                    )
                yield self._batch_keys(loader, index, batch), out

        try:
            for (guids, frame_valid), out in self._pipelined_fetch(_dispatched()):
                with profiling.span("sweep.collect"):
                    n_frames += self._collect(sal_dict, guids, frame_valid, out)
                progress.tick(int(np.sum(frame_valid)))
        finally:
            loader.close()  # releases the decode pool's liveness ref
        dt = time.time() - t0
        if n_frames:
            self._logger.info("Scored %d frames x %d views in %.2fs (%.2f frames/s)."
                              % (n_frames, num_views, dt, n_frames / dt))
            if self.al_writer is not None:
                self.al_writer.add_scalar("perf/scoring_frames_per_sec", n_frames / dt, iteration)
                for dev, stats in profiling.device_memory_stats().items():
                    self.al_writer.add_scalar("hbm/%s/bytes_in_use_gib" % dev,
                                              stats["bytes_in_use_gib"], iteration)
        return sal_dict

    @staticmethod
    def _collect(sal_dict, guids, frame_valid, out) -> int:
        """Keys one batch's fetched outputs into `sal_dict` by guid; the
        number of its valid frames."""
        n_frames = 0
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
        return n_frames

    @profiling.spanned("embed")
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
            for index, batch in enumerate(loader):
                emb = self.engine.embed_step(self._device_images(batch),
                                             num_views=self._views(batch)[0])
                yield self._batch_keys(loader, index, batch), {"embedding": emb}

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
        """Reference: strategy.py:651-679.  (checkpoints dir, writer); rank 0
        writes the config (the writer writes on rank 0 only)."""
        experiment_dir = storage.join(cfg.LOG_DIR, cfg.EXPR_NAME)
        checkpoints_dir = storage.join(experiment_dir, "checkpoints")
        if parallel.is_main():
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

    @profiling.spanned("checkpoint")
    def _save_point(self, checkpoints_dir, state, epoch, step, mkpe, lr=None) -> None:
        """The step-named checkpoint and the rolling CKPT-FINAL, written by
        rank 0 (``ckpt.save_checkpoints``), then a barrier (JAX :940, :981):
        no rank goes on to read this CKPT-FINAL (the next AL iteration's
        scorer, AL_EVAL) before it is whole."""
        ckpt.save_checkpoints(
            [os.path.join(checkpoints_dir, "CKPT-E%d-MKPE%.2f" % (step, mkpe)),
             os.path.join(checkpoints_dir, "CKPT-FINAL")], state, epoch, lr)
        parallel.process_barrier("ckpt/%s/%d" % (checkpoints_dir, step))

    @profiling.spanned("train")
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
            # RandAugment's keys: JAX's stream, split once a batch.
            key = prng.PRNGKey(int(train_cfg.RANDOM_SEED) & 0x7FFFFFFF)
            epoch, global_step = 0, int(state.step)
            if global_step:
                self._logger.info("Resuming training at step %d." % global_step)
            # Skips are summed on the device and read at log points only: a
            # per-step fetch would make every step wait for the card.
            skip_sum = torch.zeros((), dtype=torch.int64, device=self.device)
            t_start, steps_timed = time.time(), 0
            step_timer = profiling.StepTimer(device=self.device)
            while global_step < total_steps:
                epoch += 1
                batches_this_epoch = 0
                for batch in profiling.span_each("train.loader_wait", train_loader):
                    batches_this_epoch += 1
                    key, bkey = prng.split(key)
                    with profiling.span("train.prepare"):
                        images, gt_heat = self._device_batch(batch, train=True, key=bkey)
                        per_view_joint_valid = self._put(batch["per_view_joint_valid"])
                        frame_valid = self._put(batch["frame_valid"])
                    with profiling.span("train.step"):
                        state, metrics = self.engine.train_step(
                            state, images, gt_heat, per_view_joint_valid, frame_valid)
                    global_step += 1
                    steps_timed += 1
                    step_timer.tick()
                    skip_sum = skip_sum + metrics["skipped"]
                    if global_step % log_every == 0:
                        with profiling.span("train.log_point"):
                            with profiling.span("train.records"):
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
                            with profiling.span("train.records"):
                                self._write_train_records(
                                    writer, global_step, lr, last_loss, eval_results,
                                    steps_per_sec, step_timer, metrics, images, gt_heat)
                            self._logger.info(
                                "[EPOCH %d][STEP %d] loss %.4f mkpe %.2f (%.2f steps/s)"
                                % (epoch, global_step, last_loss, eval_results["mkpe"],
                                   steps_per_sec))
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
                with profiling.span("train.log_point"):
                    eval_results = self._evaluate_all(iteration_idx, state, val_loader)
                    self._save_point(checkpoints_dir, state, epoch, global_step,
                                     eval_results["mkpe"])
                    with profiling.span("train.records"):
                        writer.add_scalar("3D MKPE", eval_results["mkpe"], global_step)
                    self._logger.info("[FINAL][STEP %d] mkpe %.2f — end-of-training checkpoint "
                                      "saved." % (global_step, eval_results["mkpe"]))
        finally:
            train_loader.close()  # the decode pool's references, also on a failure
            val_loader.close()
        writer.close()
        return state

    def _write_train_records(self, writer, step, lr, loss, eval_results, steps_per_sec,
                             step_timer, metrics, images, gt_heat) -> None:
        """The metrics writer's records of a training log point."""
        writer.add_scalar("lr", lr, step)
        writer.add_scalar("3D MKPE", eval_results["mkpe"], step)
        writer.add_scalar("loss/train", loss, step)
        writer.add_pck_curves("3DPCK", step, eval_results["thresholds"], eval_results["pcks"])
        if "pckh_thresholds" in eval_results:
            writer.add_pck_curves("3DPCKH", step, eval_results["pckh_thresholds"],
                                  eval_results["pckh_pcks"])
        writer.add_scalar("steps_per_sec", steps_per_sec, step)
        if parallel.is_main():  # rank 0's first crop, rendered where it is kept
            self._log_train_figures(writer, metrics["first_heatmap"], images, gt_heat, step)
        for k, v in step_timer.summary().items():
            writer.add_scalar("perf/%s" % k, v, step)
        for dev, stats in profiling.device_memory_stats().items():
            writer.add_scalar("hbm/%s/bytes_in_use_gib" % dev, stats["bytes_in_use_gib"], step)

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

    @profiling.spanned("evaluate")
    def _evaluate_all(self, iteration_idx, state, val_loader) -> Dict:
        """3D MKPE and PCK (and PCKh) over the validation loader (reference:
        strategy.py:584-649): eval_step a batch (K1 decodes its heatmaps),
        the metrics on the host, over every rank's frames."""
        self._load_state(state)
        pairs = self._put(self.engine.pairs(val_loader.pool.get_num_view_per_frame()))
        int8_scales = None

        def _dispatched():
            nonlocal int8_scales
            for batch in val_loader:
                images = self._device_images(batch)
                if int8_scales is None:
                    int8_scales = self.engine.int8_calibrate(images, for_eval=True)
                joint_valid = self._put(batch["joint_valid"])
                out = self.engine.eval_step(images, self._put(batch["proj_matrices"]), joint_valid,
                                            pairs, int8_scales=int8_scales)
                # The GT rides with the predictions, gathered with them.
                yield None, {"keypoints_3d": out["keypoints_3d"], "joint_valid": joint_valid,
                             "gt": self._put(batch["3d_keypoints"]),
                             "frame_valid": self._put(batch["frame_valid"])}

        preds, gts, valids = [], [], []
        for _, out in self._pipelined_fetch(_dispatched()):
            mask = out["frame_valid"].astype(bool)
            preds.append(out["keypoints_3d"][mask])
            gts.append(out["gt"][mask])
            valids.append(out["joint_valid"][mask].astype(np.float32))
        pred, gt, valid = np.concatenate(preds), np.concatenate(gts), np.concatenate(valids)
        thresholds, pcks = evaluation.compute_3d_pck_figure(pred, gt, valid)
        results = {"mkpe": float(evaluation.compute_mkpe(pred, gt, valid)),
                   "thresholds": list(thresholds), "pcks": pcks}
        if self.al_cfg.DATA.TYPE != "ih26m":
            pckh_thresholds, pckh_pcks = evaluation.compute_3d_pckh_figure(pred, gt)
            results["pckh_thresholds"] = list(pckh_thresholds)
            results["pckh_pcks"] = pckh_pcks
        return results

    def evaluate_2d_pckh(self, state, val_loader) -> Tuple[list, list]:
        """2D PCKh over a validation loader (JAX strategy.py:1091-1132; the
        reference's strategy.py:548-582 is dead code with a 19-joint
        reshape): the heatmaps decoded by K1 to crop-space keypoints scaled
        by each view's box, against the crop-space GT ("2d_after_crop")."""
        from .ops import heatmap as heatmap_ops

        self._load_state(state)
        int8_scales = None

        def _dispatched():
            nonlocal int8_scales
            for batch in val_loader:
                images = self._device_images(batch)
                if int8_scales is None:
                    int8_scales = self.engine.int8_calibrate(images, for_eval=True)
                heatmaps = self.engine.forward(images, int8_scales,
                                               use_int8=self.engine.use_int8_eval)
                num_views, views = self._views(batch)
                coords = heatmap_ops.decode_keypoints_bbox(
                    heatmaps, self._put(batch["square_box"][:, views]))
                if parallel.views_split(num_views):
                    coords = parallel.all_gather_views(coords)  # every view's
                yield None, {"coords": coords, "gt": self._put(batch["2d_after_crop"]),
                             "frame_valid": self._put(batch["frame_valid"])}

        preds, gts = [], []
        for _, out in self._pipelined_fetch(_dispatched()):
            mask = out["frame_valid"].astype(bool)
            preds.append(out["coords"][mask].reshape(-1, self.num_joints, 2))
            gts.append(out["gt"][mask].reshape(-1, self.num_joints, 2))
        thresholds, pcks = evaluation.compute_pckh_2d_figure(np.concatenate(preds),
                                                             np.concatenate(gts))
        return list(thresholds), pcks

    def _prepare_val_dataset_for_eval(self, val_pool) -> FrameLoader:
        """Reference: strategy.py:905-913."""
        val_pool.label_all()
        val_pool.resample_frames(-1, rng=self._rng(3))
        return self._get_loader(val_pool, self.al_cfg.AL.INFERENCE.BATCH_SIZE,
                                self.al_cfg.AL.INFERENCE.NUM_WORKERS)

    def _evaluate_on_checkpoint(self, iteration_idx, state, checkpoint_path, val_loader) -> Dict:
        """The checkpoint's weights on `state`, evaluated; the PCK curves
        averaged over joints (reference: strategy.py:880-903)."""
        self._logger.info("AL_iter %s: loading weights from %s" % (iteration_idx, checkpoint_path))
        state = ckpt.restore_params_only(checkpoint_path, state)
        result = self._evaluate_all(iteration_idx, state, val_loader)
        result["pcks"] = [float(np.mean(p)) for p in result["pcks"]]
        if "pckh_pcks" in result:
            result["pckh_pcks"] = [float(np.mean(p)) for p in result["pckh_pcks"]]
        return result

    def run_eval(self, state, val_pool) -> Dict:
        """EXPR_TYPE == EVAL: AL.INFERENCE.RESTORE_FROM on the pool
        (reference: strategy.py:228-238)."""
        with self._prepare_val_dataset_for_eval(val_pool) as val_loader:
            result = self._evaluate_on_checkpoint(-1, state, self.al_cfg.AL.INFERENCE.RESTORE_FROM,
                                                  val_loader)
        return {-1: result}

    def run_al_eval(self, state, val_pool) -> Dict:
        """EXPR_TYPE == AL_EVAL: every AL iteration's CKPT-FINAL, keyed by
        the labeled size after it, INITIAL_AMOUNT + i * ITER_AMOUNT (the
        reference's (1 + i) * ITER_AMOUNT, strategy.py:193-226, ignores
        INITIAL_AMOUNT; the JAX package fixed it, :1180-1183)."""
        al = self.al_cfg.AL
        eval_dict = {}
        with self._prepare_val_dataset_for_eval(val_pool) as val_loader:
            if al.INFERENCE.TRAINING_EXPR_NAME:
                for iteration in range(al.ITERATIONS):
                    path = os.path.join(self.al_cfg.LOG_DIR, al.INFERENCE.TRAINING_EXPR_NAME,
                                        "ITER-%d" % iteration, "checkpoints", "CKPT-FINAL")
                    if ckpt.checkpoint_exists(path):
                        size = al.INITIAL_AMOUNT + iteration * al.ITER_AMOUNT
                        eval_dict[size] = self._evaluate_on_checkpoint(iteration, state, path,
                                                                       val_loader)
        for size, result in eval_dict.items():
            self._logger.info("size %d -> MKPE %.2f" % (size, result["mkpe"]))
        return eval_dict

    # ------------------------------------------------------------- clustering

    def cluster(self, state, train_pool) -> Dict:
        """EXPR_TYPE == CLUSTER (reference: strategy.py:137-191, reachable
        without its "CLUSETER" typo): every train frame's GT 3D pose (POSE)
        or its heatmap loss under the model (LOSS, ``Engine.loss_step``),
        keyed by guid, written to AL.CLUSTER.SAVE_PATH."""
        cfg = self.al_cfg
        train_pool.label_all()
        train_pool.resample_frames(-1, rng=self._rng(4))
        cluster_dict = {}
        if cfg.AL.CLUSTER.TYPE == "POSE":
            for frame in train_pool.data:
                cluster_dict[frame["guid"]] = np.asarray(frame["3d_keypoints"]).tolist()
        elif cfg.AL.CLUSTER.TYPE == "LOSS":
            if cfg.AL.CLUSTER.RESTORE_FROM:
                state = ckpt.restore_params_only(cfg.AL.CLUSTER.RESTORE_FROM, state)
            self._load_state(state)
            loader = self._get_loader(train_pool, cfg.TRAIN.BATCH_SIZE)

            def _dispatched():
                for index, batch in enumerate(loader):
                    images, gt_heat = self._device_batch(batch, train=False)
                    yield self._batch_keys(loader, index, batch), {
                        "loss": self.engine.loss_step(images, gt_heat,
                                                      num_views=self._views(batch)[0])}

            try:
                for (guids, valid), out in self._pipelined_fetch(_dispatched()):
                    for i, guid in enumerate(guids):
                        if valid[i]:
                            cluster_dict[guid] = float(out["loss"][i])
            finally:
                loader.close()
        else:
            raise ValueError("AL.CLUSTER.TYPE must be POSE or LOSS")
        if parallel.is_main():
            with storage.open_file(cfg.AL.CLUSTER.SAVE_PATH, "w") as f:
                json.dump(cluster_dict, f)
        return cluster_dict

    # ------------------------------------------------------- resume / restore

    def restore_dataset(self, train_pool, iteration: int):
        """Replay the guid logs of iterations before `iteration` into the
        labeled pool, and under SAL the last pseudo-labels (reference:
        strategy.py:315-336)."""
        for i in range(iteration):
            with storage.open_file(self._expr_dir("SAMPLED-GUID-ITER-%d" % i)) as f:
                train_pool.label_by_frame_guids(json.loads(f.readline()))
        if self.al_cfg.EXPR_TYPE == "SAL" and iteration > 1:
            path = self._expr_dir("SAL-GUID-ITER-%d" % (iteration - 1))
            if storage.exists(path):
                with storage.open_file(path) as f:
                    train_pool.pseudo_label_guids = json.loads(f.readline())
        self._logger.info("Restored dataset up to iteration %d; labeled size %d."
                          % (iteration - 1, len(train_pool.labeled_data)))
        return train_pool

    def _copy_previous_checkpoints(self) -> None:
        """Copy each iteration's CKPT-FINAL before AL.START_ITER, and its
        guid logs, from AL.PREVIOUS_AL_LOG_DIR (reference:
        strategy.py:338-389).  A checkpoint is one torch.save file here; a
        directory is copied whole."""
        prev = self.al_cfg.AL.PREVIOUS_AL_LOG_DIR
        for i in range(self.al_cfg.AL.START_ITER):
            src = storage.join(prev, "ITER-%d" % i, "checkpoints", "CKPT-FINAL")
            dst = self._expr_dir("ITER-%d" % i, "checkpoints", "CKPT-FINAL")
            if storage.isdir(src):
                storage.copytree(src, dst)
            elif storage.exists(src):
                storage.copy(src, dst)
            else:
                self._logger.info("Checkpoint not found: %s" % src)
            for name in ("SAMPLED-GUID-ITER-%d" % i, "SAL-GUID-ITER-%d" % i):
                if storage.exists(storage.join(prev, name)):
                    storage.copy(storage.join(prev, name), self._expr_dir(name))
                else:
                    self._logger.warning("GUID log not found: %s" % storage.join(prev, name))

    def save_init_weights_for_al(self, state) -> str:
        """Save the weights every AL iteration starts from, after
        TRAIN.RESTORE_FROM / INIT_WEIGHT (reference: strategy.py:850-866)."""
        state = self._load_weights(self.al_cfg, state)
        path = self._expr_dir("INIT-WEIGHT")
        if parallel.is_main():
            storage.makedirs(self._expr_dir())
        ckpt.save_checkpoint(path, state)  # rank 0 writes
        parallel.process_barrier("init-weight/%s" % path)
        self._logger.info("Initial AL weights saved at %s." % path)
        return path

    def prepare_al_experiments(self) -> None:
        """The experiment directory and its AL writer, with the config's
        COMMENT (reference: strategy.py:267-277); the writer writes on rank
        0 only."""
        storage.makedirs(self._expr_dir())
        self.al_writer = MetricsWriter(self._expr_dir("AL"))
        self.al_writer.add_text("comment", self.al_cfg.COMMENT, 0)
