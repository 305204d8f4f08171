"""Traffic kind ``sweep``: whole scoring sweeps of an unlabeled pool, back
to back, each one ``ActiveLearningStrategy._compute_sal_dict`` as an AL
iteration calls it (its int8 calibration included, where the configuration
scores in int8).

Set-up makes the pool's tree from the seed (rendered by worker processes
while the strategy and the seeded weights are built), reads the pool once through the program's loader with a decode
worker a core, so the view cache holds it and the window's sweeps decode
nothing, and runs one sweep, which builds the kernels and warms every
shape the window uses.  The window runs whole sweeps until `seconds` have passed;
``sweep_frames_per_s`` is every frame scored over the time to the end of
the last sweep.

The check (after the window, on the program's own outputs): in sampled
batches of the last sweep, the heatmaps against the reference forward in
the arithmetic of the configuration's ``precision.scoring``
(``precision.scoring_arithmetic``: int8 calibrated by the reference on the
same first batch; bfloat16), K1's keypoints and peaks against the reference decode of the
same heatmaps, and the sweep's per-frame outputs (3D keypoints, inlier
count, sal / al metric, MKPE) against the reference RANSAC-DLT over those
keypoints.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

import datagen
from reference import arch, counting, geometry
from reference import data as ref_data
from reference.precision import normalize_bf16, scoring_arithmetic

POSE_KEYS = ("sal_metric", "al_metric", "inlier_count", "mkpe")
POSE_RTOL = 1e-3  # relative to 1 + |reference|; float32 against float64


class Capture:
    """Keeps K1's inputs and outputs for the sampled batches of the sweep
    in progress (the program's decode wrapper is replaced while the cell
    runs)."""

    def __init__(self, module, batches):
        self.module, self.batches = module, set(int(b) for b in batches)
        self.original = module.decode_keypoints
        self.kept: Dict[int, Dict[str, torch.Tensor]] = {}
        self.current: Dict[int, Dict[str, torch.Tensor]] = {}
        self.index = 0
        module.decode_keypoints = self._decode

    def _decode(self, heatmaps, stride, valid, use_soft_argmax=False, with_peak=False):
        out = self.original(heatmaps, stride, valid, use_soft_argmax, with_peak)
        if self.index in self.batches:
            coords, peaks = out if with_peak else (out, None)
            self.current[self.index] = {"heatmaps": heatmaps, "coords": coords, "peaks": peaks}
        self.index += 1
        return out

    def begin(self):
        self.index, self.current = 0, {}

    def end(self):
        self.kept = self.current

    def close(self):
        self.module.decode_keypoints = self.original


class SweepCell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model = ctx.config["model"]
        self.data = ctx.config["data"]
        self.t = ctx.traffic
        self.B = int(ctx.cfg_value("AL.INFERENCE.BATCH_SIZE"))

    # ----------------------------------------------------------------- set-up

    def setup(self):
        from multi_view_active_learning_tpu_torch import strategy as strategy_mod
        from multi_view_active_learning_tpu_torch.data import build_dataset
        from multi_view_active_learning_tpu_torch.device import use_deterministic_algorithms
        from multi_view_active_learning_tpu_torch.kernels import decode as kdecode

        ctx = self.ctx
        tree = datagen.start_tree(os.path.join(ctx.tmp, "tree"), ctx.seed,
                                  int(self.t["pool_frames"]), 1, int(self.data["joints"]),
                                  int(self.data["views"]))
        self.root = tree.root
        self.cfg = ctx.program_config(self.root)
        use_deterministic_algorithms(ctx.device)
        self.strategy = strategy_mod.ActiveLearningStrategy(self.cfg, ctx.device)
        spec = counting.trace_model(self.model, int(self.data["image_size"]))[1].spec
        self.weights = ctx.make_weights(spec)
        self.pool = build_dataset(self.cfg, "train")
        self.pool.resample_unlabeled_data()
        self.n_batches = -(-len(self.pool.data) // self.B)
        rng = np.random.default_rng(int(ctx.seed) % (2 ** 63) ^ 0x5EED)
        k = min(int(self.t["sampled_batches"]), self.n_batches)
        self.sampled = sorted(int(b) for b in rng.choice(self.n_batches, k, replace=False))
        self.capture = Capture(kdecode, self.sampled)
        tree.wait()
        ctx.fill_view_cache(self.strategy, self.pool.data, self.B)
        ctx.fault.install(self)
        self.sweep()  # builds the kernels, warms every shape the window uses
        ctx.sync()

    def sweep(self) -> Dict:
        self.capture.begin()
        sal = self.strategy._compute_sal_dict(self.pool, self.weights,
                                             iteration=int(self.t["iteration"]))
        self.capture.end()
        return sal

    def install_spans(self, spans):
        from multi_view_active_learning_tpu_torch.data import pipeline

        s = self.strategy
        spans.wrap(s, "_compute_sal_dict", "sweep")
        spans.wrap(s, "_pipelined_fetch", "fetch", generator=True)
        spans.wrap(pipeline.FrameLoader, "__iter__", "loader", generator=True)
        spans.wrap(s, "_put", "to_device")
        spans.wrap(s.engine, "int8_calibrate", "int8_calibrate")
        spans.wrap(s.engine, "score_step", "score_step")

    # ----------------------------------------------------------------- window

    def window(self, seconds: float) -> Dict:
        ctx = self.ctx
        frames, sweep_s = 0, []
        ctx.sync()
        t0 = time.perf_counter()
        while True:
            start = time.perf_counter()
            self.sal = self.sweep()
            frames += len(self.sal["al_metric"])
            sweep_s.append(time.perf_counter() - start)
            if time.perf_counter() - t0 >= seconds:
                break
        ctx.sync()
        elapsed = time.perf_counter() - t0
        self.window_info = {"frames": frames, "seconds": elapsed, "sweeps": len(sweep_s),
                            "sweep_s": sweep_s, "crops": frames * int(self.data["views"])}
        return {"sweep_frames_per_s": frames / elapsed}

    def attempted_failed(self):
        missing = len(self.pool.data) - len(self.sal["al_metric"])
        bad = sum(1 for key in POSE_KEYS for v in self.sal[key].values() if not np.isfinite(v))
        return self.window_info["frames"], missing + bad

    # ----------------------------------------------------------------- probes

    def probes(self) -> Dict:
        """Per-layer readings beside the window: the loader alone over the
        warm pool (host clock), and the bare score step on a resident batch
        (CUDA events)."""
        s, cfg = self.strategy, self.cfg
        loader = s._get_loader(self.pool, self.B, cfg.AL.INFERENCE.NUM_WORKERS)
        t0, n, first = time.perf_counter(), 0, None
        try:
            for batch in loader:
                n += int(np.sum(batch["frame_valid"]))
                first = first or batch
        finally:
            loader.close()
        loader_rate = n / (time.perf_counter() - t0)
        images = s._device_images(first)
        args = (images, s._put(first["proj_matrices"]), s._put(first["joint_valid"]),
                s._put(s.engine.pairs(self.pool.get_num_view_per_frame())),
                s._put(first["3d_keypoints"]))
        scales = s.engine.int8_calibrate(images)
        step_ms = self.ctx.time_ms(lambda: s.engine.score_step(
            *args, al_strategy=cfg.AL.STRATEGY, int8_scales=scales), int(self.t["probe_steps"]))
        return {"loader_frames_per_s": loader_rate, "score_step_ms": step_ms}

    def release(self):
        self.capture.close()
        self.ctx.fault.remove()
        self.kept = self.capture.kept
        del self.strategy
        self.ctx.free()

    # ------------------------------------------------------------------ check

    def reference_heatmaps(self, frames: List[Dict], control: bool = False, scales=None):
        """The reference's heatmaps of `frames` in the configuration's
        scoring arithmetic (with `control`, its control's), and the scale
        table an int8 arithmetic recorded where `scales` was not given."""
        prep = ref_data.prepare_frames(frames, int(self.data["image_size"]),
                                       float(self.ctx.cfg_value("DATA.SCALE_BBOX")))
        images = torch.from_numpy(prep["images"]).to(self.ctx.device)
        B, V = images.shape[:2]
        ops = scoring_arithmetic(self.ctx.config["precision"], control, scales)
        with torch.no_grad():
            hm = arch.forward(self.model, arch.Params(self.weights), ops,
                              normalize_bf16(images.reshape((B * V,) + images.shape[2:])))
        return hm.reshape((B, V) + hm.shape[1:]), getattr(ops, "recorded", None), prep

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared for this run.  With `control`, the
        reference at the next lower precision stands in for the program's
        heatmaps (the sweep's other outputs are then the reference's own
        on them)."""
        frames = datagen.frame_records(self.root, "train")
        # An int8 arithmetic calibrates on the first batch, as the sweep does.
        scales = low_scales = None
        if self.ctx.config["precision"]["scoring"] == "int8":
            scales = self.reference_heatmaps(frames[:self.B])[1]
            if control:
                low_scales = self.reference_heatmaps(frames[:self.B], True)[1]
        stride = float(self.ctx.cfg_value("POSE_ESTIMATOR.STRIDE"))
        pairs = torch.as_tensor(geometry.view_pairs(
            int(self.data["views"]), int(self.ctx.cfg_value("AL.RANSAC_N_ITERS")),
            int(self.ctx.seed) & 0x7FFFFFFF), device=self.ctx.device)
        eps = float(self.ctx.cfg_value("AL.RANSAC_EPSILON"))
        sq_diff = sq_ref = 0.0
        decode_gap, mismatched, n_frames = 0.0, 0, 0
        for b in self.sampled:
            batch_frames = frames[b * self.B:(b + 1) * self.B]
            ref_hm, _, prep = self.reference_heatmaps(batch_frames, False, scales)
            n = len(batch_frames)
            if control:
                got = self.reference_heatmaps(batch_frames, True, low_scales)[0]
            else:
                got = self.kept[b]["heatmaps"][:n]
            sq_diff += float(torch.sum(torch.square(got.double() - ref_hm.double())))
            sq_ref += float(torch.sum(torch.square(ref_hm.double())))
            coords, peaks = geometry.decode(got, stride)
            if not control:
                k1 = self.kept[b]
                decode_gap = max(decode_gap,
                                 float(torch.amax(torch.abs(k1["coords"][:n] - coords))),
                                 float(torch.amax(torch.abs(k1["peaks"][:n] - peaks))))
            proj = torch.from_numpy(prep["proj"]).to(self.ctx.device)
            joints = torch.from_numpy(prep["joints_3d"]).to(self.ctx.device)
            valid = torch.ones(joints.shape[:2], dtype=torch.bool, device=self.ctx.device)
            ref = geometry.frame_metrics(geometry.triangulate(coords, proj, pairs, eps), joints, valid)
            if control:
                continue  # the control's outputs are the reference's own
            for i, frame in enumerate(batch_frames):
                n_frames += 1
                mismatched += not self._frame_agrees(frame["guid"], ref, i)
        out = {"heatmap_gap": (sq_diff / max(sq_ref, 1e-300)) ** 0.5}
        if not control:
            out["decode_gap"] = decode_gap
            out["pose_mismatch"] = mismatched / max(n_frames, 1)
        return out

    def _frame_agrees(self, guid: str, ref: Dict[str, torch.Tensor], i: int) -> bool:
        sal = self.sal
        if guid not in sal["al_metric"]:
            return False
        kp = torch.as_tensor(sal["pred_3d_keypoints"][guid], dtype=torch.float64)
        kr = ref["keypoints_3d"][i].cpu()
        if bool(torch.any(torch.linalg.vector_norm(kp - kr, dim=-1)
                          > POSE_RTOL * (1 + torch.linalg.vector_norm(kr, dim=-1)))):
            return False
        for key in POSE_KEYS:
            r = float(ref[key][i])
            if not abs(sal[key][guid] - r) <= POSE_RTOL * (1 + abs(r)):
                return False
        return True


def min_seconds_per_frame(ctx) -> float:
    """The least time the chip could take on one scored frame's forward
    operations (all its views), each kind of layer at its precision's peak."""
    data = ctx.config["data"]
    per_crop = counting.min_seconds_per_crop(ctx.config["model"], int(data["image_size"]),
                                             ctx.config["precision"]["layers"], ctx.peaks)
    return per_crop * int(data["views"])


def k1_bytes(ctx, batch: int) -> int:
    data = ctx.config["data"]
    side = int(data["image_size"]) // int(ctx.cfg_value("POSE_ESTIMATOR.STRIDE"))
    return counting.decode_bytes(batch * int(data["views"]) * int(data["joints"]), side * side)


CELL = SweepCell


def run(ctx) -> Dict:
    return ctx.drive(CELL(ctx))
