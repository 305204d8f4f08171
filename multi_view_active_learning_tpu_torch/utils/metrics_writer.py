"""Experiment metrics: ``metrics.jsonl`` always, TensorBoard when present.

The port's own copy of the JAX package's utils/metrics_writer.py for the
training loop and the AL writer: the same records and tags (lr,
loss/train, 3D MKPE, "3DPCK@t/average", per-keypoint curves, figures, the
sal/* histograms, the experiment's comment; reference: strategy.py:83-109,
651-679, 791-848), one JSON object a line, mirrored to TensorBoard when
``torch.utils.tensorboard`` imports.  Images land as PNGs under
``<log_dir>/images/``.  Under a process group only rank 0's writer writes;
on the other ranks it makes no directory and records nothing.
"""

from __future__ import annotations

import io
import json
import time
import weakref
from typing import Sequence

import numpy as np

from .. import parallel
from . import storage


def _close_quietly(f) -> None:
    try:
        f.close()
    except Exception:
        pass


def _try_tb(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:
        return None


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._jsonl = self._tb = None
        self.enabled = parallel.is_main()
        if not self.enabled:
            return
        storage.makedirs(log_dir)
        if storage.is_remote(log_dir):
            # Object stores cannot append: each writer streams a new
            # numbered shard; readers join metrics-*.jsonl in name order.
            existing = [n for n in storage.listdir(log_dir)
                        if n.startswith("metrics-") and n.endswith(".jsonl")]
            self._jsonl = storage.open_file(
                storage.join(log_dir, "metrics-%03d.jsonl" % len(existing)), "w")
        else:
            self._jsonl = storage.open_file(storage.join(log_dir, "metrics.jsonl"), "a")
        # TensorBoard writes local files only.
        self._tb = None if storage.is_remote(log_dir) else _try_tb(log_dir)
        self._finalizer = weakref.finalize(self, _close_quietly, self._jsonl)

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step)})
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        """A histogram's summary (count, mean, std, min, max) in the JSONL
        record; the values themselves in the TensorBoard mirror."""
        arr = np.asarray(values, dtype=np.float64)
        n = int(arr.size)
        self._write({"tag": tag, "kind": "histogram", "step": int(step), "count": n,
                     "mean": float(arr.mean()) if n else 0.0,
                     "std": float(arr.std()) if n else 0.0,
                     "min": float(arr.min()) if n else 0.0,
                     "max": float(arr.max()) if n else 0.0})
        if self._tb:
            self._tb.add_histogram(tag, arr, step)

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        self._write({"tag": tag, "kind": "text", "text": text, "step": int(step)})
        if self._tb:
            self._tb.add_text(tag, text, step)

    def add_image(self, tag: str, image, step: int) -> None:
        """An HWC uint8 image: a PNG under <log_dir>/images/, a JSONL
        pointer to it, and the TensorBoard mirror."""
        if not self.enabled:
            return
        arr = np.ascontiguousarray(np.asarray(image, dtype=np.uint8))
        name = "%s-%d.png" % (tag.replace("/", "_"), int(step))
        rel = "images/" + name
        storage.makedirs(storage.join(self.log_dir, "images"))
        try:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            with storage.open_file(storage.join(self.log_dir, "images", name), "wb") as f:
                f.write(buf.getvalue())
        except Exception:
            rel = None
        self._write({"tag": tag, "kind": "image", "step": int(step),
                     "height": int(arr.shape[0]), "width": int(arr.shape[1]), "file": rel})
        if self._tb:
            self._tb.add_image(tag, arr, step, dataformats="HWC")

    def add_pck_curves(self, metric_name: str, step: int, thresholds: Sequence[float], pcks,
                       render_figures: bool = True) -> None:
        """Per-threshold averages and per-keypoint scalars, plus the PCK
        curve figures (reference: strategy.py:808-848)."""
        from . import visualization

        if not self.enabled:
            return
        num_joints = len(pcks[0])
        per_joint = [[] for _ in range(num_joints)]
        avgs = []
        for threshold, pck in zip(thresholds, pcks):
            avg = float(np.mean(pck))
            avgs.append(avg)
            self.add_scalar("%s@%.1f/average" % (metric_name, threshold), avg, step)
            for kp_id, v in enumerate(pck):
                self.add_scalar("%s@%.1f/keypoint-%d" % (metric_name, threshold, kp_id), v, step)
                per_joint[kp_id].append(v)
        for kp_id in range(num_joints):
            self.add_scalar("%s-AVG/keypoint-%d" % (metric_name, kp_id),
                            float(np.mean(per_joint[kp_id])), step)
            if render_figures:
                self.add_image("%s/keypoint-%d" % (metric_name, kp_id),
                               visualization.plot_pckh_figure(thresholds, per_joint[kp_id]), step)
        if render_figures:
            self.add_image("%s/average" % metric_name,
                           visualization.plot_pckh_figure(thresholds, avgs), step)

    def _write(self, record: dict) -> None:
        if not self.enabled:
            return
        record["time"] = time.time()
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        # An explicit close raises (for remote shards it is the upload);
        # only the exit finalizer is quiet.
        if not self.enabled:
            return
        self._finalizer.detach()
        try:
            self._jsonl.close()
        finally:
            if self._tb:
                self._tb.close()
