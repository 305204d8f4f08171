"""Host side of the batch pipeline: per-view decode, crop and resize, and
fixed-shape batches.

The port's own copy of the JAX package's data/pipeline.py: the host half,
and ``device_prepare``, which finishes a training batch on the device.
Split of labor against the reference's all-on-CPU prepare_single_view
(dataset/dataset.py:158-220):

  host (numpy/PIL or the native decoder, per view): JPEG decode, BGR flip,
    square + scaled bbox, crop, camera intrinsics after crop and resize,
    3D -> 2D projection, Lanczos resize to the model input.  Emits **uint8**
    images, a quarter of the bytes of the reference's float32 tensors.

  device (``Engine.score_step``): ImageNet normalization, fused with the
    forward; under DATA.DEVICE_CROP also the crop + resize
    (ops/image.py::crop_resize_uint8).  For training, ``device_prepare``
    renders the GT heatmaps and normalizes in float32.

Batches are fixed-shape: the last partial batch is padded and flagged in
``frame_valid``.  Worker processes run host code only (numpy, PIL, the
native decoder) and never touch CUDA.  Under view sharding a loader's
``view_shard`` = (view axis, view column) makes it decode only its column's
block of each frame's views when the axis divides their count; every
other array still holds every view.
"""

from __future__ import annotations

import atexit
import io
import multiprocessing
import os
import sys
import threading
from collections import OrderedDict, deque
from concurrent.futures import ProcessPoolExecutor
from queue import Full, Queue
from typing import Dict, Iterator, List, Tuple

import numpy as np
from PIL import Image

from .. import parallel
from ..ops import geometry
from ..utils import storage


class _ViewCache:
    """LRU of decoded + cropped + resized views keyed by (path, bbox, size).

    The reference re-decodes every view on every epoch and every pool
    sweep (reference: dataset/dataset.py:76-96, 158-214); views are
    content-static, so a cache needs no invalidation, and from the second
    sweep over a pool the host decode drops out."""

    def __init__(self):
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key]
            self.misses += 1
            return None

    def put(self, key, value, max_entries: int):
        if max_entries <= 0:
            return
        with self._lock:
            self._store[key] = value
            self._store.move_to_end(key)
            while len(self._store) > max_entries:
                self._store.popitem(last=False)

    def clear(self):
        with self._lock:
            self._store.clear()


VIEW_CACHE = _ViewCache()

# A decoded full frame is many times the bytes of a 256x256 crop, so under
# DEVICE_CROP the entry budget is divided by this factor.
_DEVICE_CROP_CACHE_DIVISOR = 32


# THE process-wide decode pool, grown to the largest worker count asked
# for; pools grown past are retired and shut down with their last holder
# (_EXECUTOR_REFS counts the live FrameLoaders of each pool, by id).
_SHARED_EXECUTOR: ProcessPoolExecutor | None = None
_SHARED_EXECUTOR_SIZE = 0
_RETIRED_EXECUTORS: List[ProcessPoolExecutor] = []
_EXECUTOR_REFS: Dict[int, int] = {}
_SHARED_EXECUTORS_LOCK = threading.RLock()


def _main_module_reimportable() -> bool:
    """forkserver and spawn re-import __main__ in each worker
    (multiprocessing.spawn._fixup_main_from_path / _name); a process driven
    from stdin or a REPL whose main names a file that does not exist would
    crash every worker.  True when that fixup can succeed."""
    main = sys.modules.get("__main__")
    if main is None:
        return True
    if getattr(main, "__spec__", None) is not None:  # python -m: re-imported by name
        return True
    main_file = getattr(main, "__file__", None)
    if main_file is None:  # -c or interactive: no fixup is attempted
        return True
    return os.path.isfile(main_file)


def _shared_executor(num_workers: int) -> ProcessPoolExecutor | None:
    """The process-wide decode worker pool, grown to the largest worker
    count ever asked for (loaders with different NUM_WORKERS share one
    pool, each worker warming one private VIEW_CACHE).

    Workers come from a 'forkserver': forked from a single-threaded server
    process that preloads this module, never from this process, which may
    hold the CUDA context, prefetch threads and their locks (a child forked
    from it must never touch CUDA, and one forked while another thread holds
    a lock can deadlock).  'spawn' where there is no forkserver; 'fork'
    only where __main__ cannot be re-imported (forkserver and spawn would
    crash every worker re-importing it; the workers then run host code
    only, which bounds the risk to the allocator and logging locks); None,
    and callers decode inline, where neither works."""
    global _SHARED_EXECUTOR, _SHARED_EXECUTOR_SIZE
    with _SHARED_EXECUTORS_LOCK:
        ex = _SHARED_EXECUTOR
        if ex is not None and _SHARED_EXECUTOR_SIZE < num_workers:
            # Grow: a sweep mid-iteration may still hold the smaller pool,
            # so it is shut down now only without a live holder, else when
            # its last holder releases it.
            if _EXECUTOR_REFS.get(id(ex), 0) <= 0:
                ex.shutdown(wait=False, cancel_futures=True)
            else:
                _RETIRED_EXECUTORS.append(ex)
            ex = None
        if ex is None:
            if _main_module_reimportable():
                try:
                    ctx = multiprocessing.get_context("forkserver")
                    ctx.set_forkserver_preload([__name__])
                except ValueError:  # platforms without forkserver
                    ctx = multiprocessing.get_context("spawn")
            else:
                try:
                    ctx = multiprocessing.get_context("fork")
                except ValueError:
                    return None
            ex = ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx)
            _SHARED_EXECUTOR = ex
            _SHARED_EXECUTOR_SIZE = num_workers
        return ex


def _acquire_shared_executor(num_workers: int) -> ProcessPoolExecutor | None:
    """`_shared_executor` plus a liveness ref; callers MUST pair it with
    `_release_shared_executor` so grown-past pools can be reclaimed."""
    with _SHARED_EXECUTORS_LOCK:
        ex = _shared_executor(num_workers)
        if ex is not None:
            _EXECUTOR_REFS[id(ex)] = _EXECUTOR_REFS.get(id(ex), 0) + 1
        return ex


def _release_shared_executor(ex: ProcessPoolExecutor | None) -> None:
    """Drop one liveness ref.  A retired pool shuts down with its last
    holder; the current pool stays warm for the next loader."""
    if ex is None:
        return
    with _SHARED_EXECUTORS_LOCK:
        n = _EXECUTOR_REFS.get(id(ex), 0) - 1
        if n > 0:
            _EXECUTOR_REFS[id(ex)] = n
            return
        _EXECUTOR_REFS.pop(id(ex), None)
        if ex is _SHARED_EXECUTOR:
            return
        try:
            _RETIRED_EXECUTORS.remove(ex)
        except ValueError:
            return  # already shut down (shutdown_shared_executors)
        ex.shutdown(wait=False, cancel_futures=True)


def shutdown_shared_executors(wait: bool = False) -> None:
    """Stop every decode worker (registered at exit); with `wait`, return
    only once each has exited."""
    global _SHARED_EXECUTOR, _SHARED_EXECUTOR_SIZE
    with _SHARED_EXECUTORS_LOCK:
        if _SHARED_EXECUTOR is not None:
            _SHARED_EXECUTOR.shutdown(wait=wait, cancel_futures=True)
        for ex in _RETIRED_EXECUTORS:
            ex.shutdown(wait=wait, cancel_futures=True)
        _RETIRED_EXECUTORS.clear()
        _EXECUTOR_REFS.clear()
        _SHARED_EXECUTOR = None
        _SHARED_EXECUTOR_SIZE = 0


atexit.register(shutdown_shared_executors)


def stop_decode_processes() -> None:
    """Stop the decode workers and the forkserver that forked them, and wait
    for both.  Left running, the forkserver outlives this process until it
    reads the end of its pipe; a program that must leave no process behind
    when it exits calls this first.  The next pool starts a new forkserver."""
    import multiprocessing.forkserver

    shutdown_shared_executors(wait=True)
    multiprocessing.forkserver._forkserver._stop()


def cuda_initialized() -> bool:
    """Worker-side probe: True if this process has initialized CUDA.  A
    decode worker must never do so (it runs host code only)."""
    return "torch" in sys.modules and sys.modules["torch"].cuda.is_initialized()


def native_decoder_available() -> bool:
    """Worker-side probe: whether the native decoder loads in this process."""
    from . import native

    return native.available()


def _kept_views(num_views: int, view_shard: Tuple[int, int]) -> range:
    """The views whose images a loader with `view_shard` = (view axis, view
    column) decodes of a frame of `num_views` (``parallel.view_block``)."""
    return range(num_views)[parallel.view_block(num_views, *view_shard)]


def _frame_view_keys(frame: dict, data_cfg, view_shard: Tuple[int, int] = (1, 0)) -> List[tuple]:
    """The VIEW_CACHE keys prepare_views_host uses for each view of
    `frame` it decodes (the same bbox math), so the loader can find a frame
    whose views are all cached in this process and skip the worker round
    trip."""
    keys = []
    views = list(frame["views"].values())
    for i in _kept_views(len(views), view_shard):
        view = views[i]
        if data_cfg.DEVICE_CROP:
            keys.append((view["path"], "full"))
            continue
        bbox = geometry.get_square_bbox(tuple(view["box"]))
        bbox = geometry.scale_bbox(bbox, data_cfg.SCALE_BBOX)
        keys.append((view["path"], tuple(bbox), data_cfg.INPUT_WIDTH, data_cfg.INPUT_HEIGHT))
    return keys


def _effective_cache_size(data_cfg) -> int:
    size = data_cfg.VIEW_CACHE_SIZE
    if size > 0 and data_cfg.DEVICE_CROP:
        # Floor at 1: a small positive budget must still cache.
        size = max(1, size // _DEVICE_CROP_CACHE_DIVISOR)
    return size


def prepare_views_host(frame: dict, data_cfg, gt_stride: int,
                       view_shard: Tuple[int, int] = (1, 0)) -> Dict[str, np.ndarray]:
    """Prepare every view of one frame on the host; with `view_shard` the
    images are those of ``_kept_views`` only, the camera data every view's.

    Reference: dataset/dataset.py:112-220 (prepare_frame +
    prepare_single_view) without normalization, heatmaps and augmentation,
    which run on the device."""
    if "pseudo_3d_keypoints" in frame:
        kp3d = np.asarray(frame["pseudo_3d_keypoints"], dtype=np.float64)[:, :3]
        sigma = data_cfg.PSEUDO_LABEL_SIGMA
    else:
        kp3d = np.asarray(frame["3d_keypoints"], dtype=np.float64)[:, :3]
        sigma = data_cfg.SIGMA

    device_crop = data_cfg.DEVICE_CROP
    use_native = data_cfg.USE_NATIVE_LOADER
    if use_native:
        from . import native

        use_native = native.available()

    images, projs, kps, kps_after_crop, sq_boxes, pvjv = [], [], [], [], [], []
    kept = _kept_views(len(frame["views"]), view_shard)
    for index, (camera_name, view) in enumerate(frame["views"].items()):
        bbox = geometry.get_square_bbox(tuple(view["box"]))
        bbox = geometry.scale_bbox(bbox, data_cfg.SCALE_BBOX)
        if index not in kept:
            image = None
        elif device_crop:
            # Full frame only; the crop + resize runs on the device.
            cache_key = (view["path"], "full")
            cache_size = _effective_cache_size(data_cfg)
            image = VIEW_CACHE.get(cache_key) if cache_size > 0 else None
            if image is None:
                image = np.asarray(Image.open(io.BytesIO(storage.read_bytes(view["path"]))))
                image = np.ascontiguousarray(image[..., ::-1])  # BGR flip
                if cache_size > 0:
                    VIEW_CACHE.put(cache_key, image, cache_size)
        else:
            cache_key = (view["path"], tuple(bbox), data_cfg.INPUT_WIDTH, data_cfg.INPUT_HEIGHT)
            cache_size = data_cfg.VIEW_CACHE_SIZE
            cached = VIEW_CACHE.get(cache_key) if cache_size > 0 else None
            image = cached
            if image is None and use_native:
                # Decode + crop + Lanczos + BGR flip in one call; the flip is
                # channel-only, so flipping after the resize is the same.
                image = native.decode_crop_resize(
                    storage.read_bytes(view["path"]), bbox, data_cfg.INPUT_WIDTH,
                    data_cfg.INPUT_HEIGHT, bgr_flip=True,
                    fast_scale=data_cfg.NATIVE_FAST_SCALE,
                )
            if image is None:  # PIL (the reference's exact path)
                image = np.asarray(Image.open(io.BytesIO(storage.read_bytes(view["path"]))))
                image = image[..., ::-1]  # BGR flip (reference: dataset.py:162)
                # crop_image zero-fills to the exact bbox extent.
                image = geometry.crop_image(image, bbox)
                image = Image.fromarray(image).resize(
                    (data_cfg.INPUT_WIDTH, data_cfg.INPUT_HEIGHT), resample=Image.LANCZOS
                )
                image = np.asarray(image, dtype=np.uint8)
            if cached is None and cache_size > 0:
                VIEW_CACHE.put(cache_key, image, cache_size)

        # Camera and keypoint math: the same in both modes (it depends on
        # the bbox, not on the pixels).
        cam = geometry.Camera(view["camera"]["R"], view["camera"]["t"], view["camera"]["K"],
                              view["camera"]["dist"], name=camera_name)
        crop_shape = (bbox[3] - bbox[1], bbox[2] - bbox[0])
        cam.update_after_crop(bbox)
        kps_after_crop.append(cam.project(kp3d).astype(np.float32))
        cam.update_after_resize(crop_shape, data_cfg.INPUT_WIDTH, data_cfg.INPUT_HEIGHT)
        projs.append(cam.projection.astype(np.float32))
        kps.append(cam.project(kp3d).astype(np.float32))
        if image is not None:
            images.append(image)
        sq_boxes.append(np.asarray(bbox, dtype=np.float32))
        pvjv.append(np.asarray(view["per_view_joint_valid"], dtype=bool))

    return {
        # [V, H, W, 3] uint8 crops (the kept views); under DATA.DEVICE_CROP
        # full frames (one frame size per dataset).
        "images": np.stack(images),
        "proj_matrices": np.stack(projs),  # [V, 3, 4]
        "2d_keypoints": np.stack(kps),  # [V, K, 2] after the resize
        "2d_after_crop": np.stack(kps_after_crop),
        "square_box": np.stack(sq_boxes),  # [V, 4]
        "per_view_joint_valid": np.stack(pvjv),  # [V, K]
        "3d_keypoints": np.asarray(frame["3d_keypoints"], dtype=np.float32)[:, :3],
        "joint_valid": np.asarray(frame["joint_valid"], dtype=bool),
        "sigma": np.float32(sigma),
        "pose": np.int64(frame["pose"]),
        "frame_id": np.int64(frame["frame_id"]),
        "guid": frame["guid"],
    }


class FrameLoader:
    """Iterate a FramePool's current `data` view in fixed-size batches.

    With `num_shards > 1` each process loads its `shard_index`-strided
    subset, the DistributedSampler equivalent (reference:
    strategy.py:747-760), and every shard emits the longest shard's batch
    count (shards are a mesh's data rows).  `view_shard` (view axis, view
    column) selects the views whose images are decoded (``_kept_views``).  A
    background thread prefetches `prefetch` batches, so host decode
    overlaps device compute; `num_workers` decode processes share the work
    of a sweep.
    """

    def __init__(self, pool, data_cfg, gt_stride: int, batch_size: int, num_shards: int = 1,
                 shard_index: int = 0, prefetch: int = 2, num_workers: int = 0,
                 view_shard: Tuple[int, int] = (1, 0)):
        self.pool = pool
        self.data_cfg = data_cfg
        self.gt_stride = gt_stride
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.view_shard = tuple(view_shard)
        self._executor: ProcessPoolExecutor | None = None
        self._shard_guids_cache = None

    def __len__(self) -> int:
        if self.num_shards > 1:
            # Every shard steps as often as the longest one (padded
            # batches), so collectives across processes stay aligned.
            n = (len(self.pool.data) + self.num_shards - 1) // self.num_shards
        else:
            n = len(self.pool.data)
        return (n + self.batch_size - 1) // self.batch_size

    def _shard_guid_lists(self) -> List[List[str]]:
        """Per-shard guid lists, memoized per pool-data snapshot.  pool.data
        is rebound (never mutated) by the resample methods, so the cache is
        checked with `is` against the very list it sliced (an id() could be
        reused after collection) and holds that list alive."""
        cached = self._shard_guids_cache
        if cached is None or cached[0] is not self.pool.data:
            lists = [[f["guid"] for f in self.pool.data[s::self.num_shards]]
                     for s in range(self.num_shards)]
            self._shard_guids_cache = (self.pool.data, lists)
            return lists
        return cached[1]

    def global_batch_layout(self, batch_index: int):
        """(guids, frame_valid) of EVERY shard's `batch_index`-th batch,
        concatenated in shard order: the host-side keys of a global batch
        assembled from the per-process batches.  Uses pool metadata only."""
        B = self.batch_size
        guids: List[str] = []
        valid = np.zeros(self.num_shards * B, bool)
        shard_guids = self._shard_guid_lists()
        for shard in range(self.num_shards):
            frames = shard_guids[shard]
            start = batch_index * B
            chunk = list(frames[start:start + B])
            valid[shard * B:shard * B + len(chunk)] = True
            pad = chunk[-1] if chunk else (frames[-1] if frames else self.pool.data[0]["guid"])
            chunk += [pad] * (B - len(chunk))
            guids.extend(chunk)
        return guids, valid

    def _ensure_executor(self) -> ProcessPoolExecutor | None:
        """The decode worker pool (the torch DataLoader `num_workers`
        analog, reference: strategy.py:747-760), fetched again every sweep:
        a loader with more workers may have grown the shared pool."""
        if self.num_workers > 0:
            ex = _acquire_shared_executor(self.num_workers)
            if ex is self._executor:
                _release_shared_executor(ex)  # already hold a ref
            else:
                _release_shared_executor(self._executor)
                self._executor = ex
        return self._executor

    def close(self) -> None:
        ex, self._executor = self._executor, None
        _release_shared_executor(ex)

    def __enter__(self) -> "FrameLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _prepared(self, frames) -> Iterator[Dict]:
        """Per-frame host prep, in order, spread over the workers with a
        bounded window of frames in flight.

        Each worker result back-fills THIS process's VIEW_CACHE, and a frame
        whose views are all cached here is prepared inline (no decode, no
        pickling), which is every frame of a pool's second sweep."""
        ex = self._ensure_executor()
        if ex is None:
            for f in frames:
                yield prepare_views_host(f, self.data_cfg, self.gt_stride, self.view_shard)
            return
        cache_size = _effective_cache_size(self.data_cfg)
        window = max(2 * self.num_workers, self.batch_size)
        pending: deque = deque()  # prepared dicts or (future, view_keys)

        def submit(f):
            keys = None
            if cache_size > 0:
                keys = _frame_view_keys(f, self.data_cfg, self.view_shard)
                if all(VIEW_CACHE.get(k) is not None for k in keys):
                    return prepare_views_host(f, self.data_cfg, self.gt_stride, self.view_shard)
            return ex.submit(prepare_views_host, f, self.data_cfg, self.gt_stride,
                             self.view_shard), keys

        def resolve(item):
            if isinstance(item, dict):
                return item
            fut, keys = item
            out = fut.result()
            if keys is not None:
                for key, img in zip(keys, out["images"]):
                    VIEW_CACHE.put(key, img, cache_size)
            return out

        it = iter(frames)

        def fill():
            # Keep up to `window` worker futures in flight, but stop looking
            # ahead while every pending item is an inline cache hit: those
            # are done already, and prepared frames queued ahead only grow
            # the live buffers.
            while len(pending) < window:
                if pending and all(isinstance(p, dict) for p in pending):
                    return
                try:
                    f = next(it)
                except StopIteration:
                    return
                pending.append(submit(f))

        try:
            fill()
            while pending:
                out = resolve(pending.popleft())
                fill()
                yield out
        finally:
            while pending:
                item = pending.popleft()
                if not isinstance(item, dict):
                    item[0].cancel()

    def _batches(self) -> Iterator[Dict]:
        frames = self.pool.data[self.shard_index::self.num_shards]
        B = self.batch_size
        prepared_it = self._prepared(frames)
        pad_frame = None
        for b in range(len(self)):
            n_real = max(0, min(B, len(frames) - b * B))
            prepared = [next(prepared_it) for _ in range(n_real)]
            valid = np.zeros(B, bool)
            valid[:n_real] = True
            if prepared:
                pad_frame = prepared[-1]
            elif pad_frame is None:
                # A shard shorter than the longest with no frames at all:
                # any pool frame, prepared once, pads it (all rows invalid).
                pad_frame = prepare_views_host(self.pool.data[0], self.data_cfg, self.gt_stride,
                                               self.view_shard)
            while len(prepared) < B:  # pad to the fixed shape
                prepared.append(pad_frame)
            batch = {key: np.stack([p[key] for p in prepared]) for key in prepared[0]
                     if key != "guid"}
            batch["guid"] = [p["guid"] for p in prepared]
            batch["frame_valid"] = valid
            yield batch

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: Queue = Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def put(item) -> bool:
            # Gives up when the consumer abandoned the iterator, so the
            # prefetch thread never stays blocked on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
            except BaseException as e:  # raised again in the consumer
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()


def device_prepare(images_u8, keypoints_2d, sigma, rng_key=None, stride: int = 4,
                   train: bool = False, num_aug: int = 0, magnitude: int = 0,
                   use_rotation: bool = True, use_image_aug: bool = True,
                   const_magnitude: bool = True, num_views=None):
    """Finish a training (or eval) batch on the device (JAX
    data/pipeline.py:395-440): GT Gaussian heatmaps at the keypoints over
    the stride with each frame's sigma, RandAugment on images and heatmaps
    together when `train` and `num_aug` > 0 (data/augmentation.py, drawn
    from the threefry key `rng_key`), then float32 ImageNet normalization.

    images_u8: uint8 [B, V, H, W, 3]; keypoints_2d: [B, V, K, 2] after the
    resize; sigma: [B].  Returns (images float32 [B, V, H, W, 3],
    gt_heatmaps float32 [B, V, K, H / stride, W / stride]).  Under a
    process group the batch is this rank's crops of the global
    ``[B * data, num_views]`` batch (its data row's frames and, under view
    sharding, its views, ``parallel.view_slice(num_views)``; `num_views`
    defaults to the images'), and RandAugment applies those crops' draws of
    the global batch's."""
    import torch

    from ..ops import heatmap

    B, V, H, W, _ = images_u8.shape
    h, w = H // stride, W // stride
    heat = heatmap.render_gaussian_heatmaps(
        keypoints_2d.to(torch.float32) / float(stride), h, w,
        sigma.to(torch.float32)[:, None, None, None, None])  # [B, V, K, h, w]
    images = images_u8.to(torch.float32)
    if train and num_aug > 0:
        from . import augmentation

        if rng_key is None:
            raise ValueError("DATA.NUM_AUG > 0 needs an rng_key for the training batch")
        K = heat.shape[2]
        total_views = V if num_views is None else int(num_views)
        views = np.arange(total_views)[parallel.view_slice(total_views)]
        if len(views) != V:
            raise ValueError("images hold %d views; this rank holds %d of %d"
                             % (V, len(views), total_views))
        frames = parallel.data_index() * B + np.arange(B)
        images, heat = augmentation.rand_augment(
            rng_key, images.reshape(B * V, H, W, 3), heat.reshape(B * V, K, h, w), num_aug,
            magnitude, use_rotation, use_image_aug, const_magnitude,
            total_rows=parallel.current_mesh().data * B * total_views,
            rows=(frames[:, None] * total_views + views[None, :]).reshape(-1))
        images, heat = images.reshape(B, V, H, W, 3), heat.reshape(B, V, K, h, w)
    mean, std = _imagenet_stats(images_u8.device)
    images = (images / 255.0 - mean) / std
    return images, heat


_STATS = {}


def _imagenet_stats(device):
    """ImageNet mean and std as float32 tensors on `device`, uploaded once
    (a copy from pageable host memory would stall the host every batch)."""
    if device not in _STATS:
        from ..device import to_device

        _STATS[device] = tuple(to_device(a, device) for a in (geometry.IMAGENET_MEAN,
                                                               geometry.IMAGENET_STD))
    return _STATS[device]
