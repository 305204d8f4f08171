"""Traffic kind ``train``: one ``ActiveLearningStrategy._train`` call, as an
AL iteration trains, timed whole.

Set-up makes the tree from the seed, the strategy and a TrainState of the
seeded weights, and reads every training and validation view through the
program's loader once, with a decode worker a core, so the view cache
holds them.  It then drives that
state through its first steps by a ``_train`` call of `first_steps` steps
(its one log point evaluates the validation frames and saves the
checkpoints, which warms that path too), keeping the losses, the first
step's Adam moment and the state after the last of them for the check.
The window's call runs a fixed number of steps, `seconds` times the
traffic's nominal `steps_per_second`, with LOG_EVERY_ITER equal to
TOTAL_STEPS, so the call ends in its one log point as an AL iteration's
training does.  ``train_frames_per_s`` is the frames trained over the
whole call.

A cell on n cards (``chips`` > 1) runs n ranks, rank 0 this process
(``harness.Context.start_ranks``): each rank trains on its shard of the
frames at the traffic's batch (TRAIN.BATCH_SIZE a rank), and caches the
views of its shard and the validation frames in set-up; the program sums
the gradients and the BatchNorm statistics over the ranks.  The window is
timed on rank 0 from a barrier before its call, and
``train_frames_per_s`` counts every rank's frames.  Rank 0 alone keeps
what the check compares, which is then the global batch's: the reference
trains on the n shards' batches together, its BatchNorm over all of them,
its convs rematerialized in the backward pass so that the global batch
fits (``training.run_steps(remat=True)``).

The check (after the window): the reference trains the same weights on
the same frames (its own decode of the tree's files, its own targets, the
loader's order worked out from RANDOM_SEED) for `first_steps` steps and is
compared with what the program's steps left: each step's loss, the first
gradient by leaf (Adam's first moment over 1 - beta1), the change of each
parameter and of each BatchNorm statistic by leaf.  The window's own call
is checked at its last step, which the reference follows from the
program's state before it (``check_window``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

import datagen
from harness import FrameList
from reference import counting, training
from reference import data as ref_data
from reference.precision import normalize_f32


class TrainCell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model = ctx.config["model"]
        self.data = ctx.config["data"]
        self.t = ctx.traffic
        self.B = int(ctx.cfg_value("TRAIN.BATCH_SIZE"))
        self.first = int(self.t["first_steps"])

    def setup(self):
        from multi_view_active_learning_tpu_torch import strategy as strategy_mod
        from multi_view_active_learning_tpu_torch.data import build_dataset
        from multi_view_active_learning_tpu_torch.device import use_deterministic_algorithms

        ctx = self.ctx
        tree = None
        if ctx.rank == 0:
            tree = datagen.start_tree(os.path.join(ctx.tmp, "tree"), ctx.seed,
                                      int(self.t["train_frames"]), int(self.t["val_frames"]),
                                      int(self.data["joints"]), int(self.data["views"]))
            self.root = tree.root
            ctx.start_ranks(tree=self.root)
        else:
            self.root = ctx.shared["tree"]
        ctx.join_group()
        self.cfg = ctx.program_config(self.root)
        use_deterministic_algorithms(ctx.device)
        s = self.strategy = strategy_mod.ActiveLearningStrategy(self.cfg, ctx.device)
        spec = counting.trace_model(self.model, int(self.data["image_size"]))[1].spec
        self.weights = ctx.make_weights(spec)
        self.state = s.engine.state_from_state_dict(self.weights)
        self.train_pool = build_dataset(self.cfg, "train")
        self.val_pool = build_dataset(self.cfg, "val")
        self.train_pool.label_all()
        if tree is not None:
            tree.wait()
        ctx.barrier("tree")
        # Each rank's loader reads every world-th frame of what it is given.
        frames = self._shard() + list(self.val_pool.unlabeled_data.values())
        ctx.fill_view_cache(s, [f for f in frames for _ in range(ctx.world)], self.B)
        ctx.fault.install(self)
        # The first steps, through the window's own call.
        engine, kept = s.engine, {"losses": []}
        original = engine.train_step

        def recording_step(state, *args):
            state, metrics = original(state, *args)
            kept["losses"].append(metrics["loss"].detach().clone())
            if len(kept["losses"]) == 1:
                kept["mu"] = {n: t.detach().clone() for n, t in state.mu.items()}
                kept["first_heatmap"] = metrics["first_heatmap"].detach().clone()
                kept["first_stats"] = {n: t.detach().clone() for n, t in state.buffers.items()}
            return state, metrics

        engine.train_step = recording_step
        try:
            self.state = self.train(self.first)
        finally:
            engine.train_step = original
        kept["params"] = {n: t.detach().clone() for n, t in self.state.params.items()}
        kept["buffers"] = {n: t.detach().clone() for n, t in self.state.buffers.items()}
        kept["count"] = int(self.state.count)
        self.kept = kept
        # A fixed amount of work for a window of about `seconds`: the
        # traffic's nominal steps a second, not a rate timed on this host.
        self.steps = max(int(self.t["min_steps"]),
                         int(round(self.ctx.seconds * float(self.t["steps_per_second"]))))
        self._keep_last_window_step()

    def _shard(self) -> List[Dict]:
        """The training frames this rank's loader reads: all of them on one
        card; on n, its shard of their training order (every n-th)."""
        frames = list(self.train_pool.labeled_data)
        if self.ctx.world == 1:
            return frames
        by_guid = {f["guid"]: f for f in frames}
        mine = self._order()[self.ctx.rank::self.ctx.world]
        return [by_guid[g] for g in dict.fromkeys(f["guid"] for f in mine)]

    def _order(self) -> List[Dict]:
        """The training frames in the order a ``_train`` call's loaders
        read them, as the reference's records: the labeled frames in reading
        order, TRAIN's epoch of DATA.EPOCH_SIZE copies, permuted by
        ``default_rng(RANDOM_SEED + 2)``; the same order in every call."""
        frames = datagen.frame_records(self.root, "train")
        copies = int(self.ctx.cfg_value("DATA.EPOCH_SIZE")) // len(frames)
        order = list(frames) * (1 + copies)
        perm = np.random.default_rng((int(self.ctx.seed) + 2) & 0x7FFFFFFF).permutation(len(order))
        return [order[i] for i in perm]

    def _keep_last_window_step(self):
        """In the window's call, keep the state its last step starts from
        and the parameters it leaves (a copy of each flat buffer, on the
        device: five copies in the whole window), and the loss that step
        returns, for the check.  A traced run's second window keeps
        nothing."""
        engine, last, calls = self.strategy.engine, self.steps - 1, [0]
        original = engine.train_step
        kept = self.kept_window = {}

        def step(state, *args):
            if calls[0] == last:
                kept["flat"] = {k: v.clone() for k, v in state.flat.items()}
                kept["count"] = state.count.clone()
            state, metrics = original(state, *args)
            if calls[0] == last:
                kept["after"] = state.flat["params"].clone()
                kept["loss"] = metrics["loss"].detach().clone()
            calls[0] += 1
            return state, metrics

        engine.train_step = step
        self._restore_step = lambda: setattr(engine, "train_step", original)

    def _step_ms(self) -> float:
        """Engine.train_step on one resident batch, on a copy of the state
        (CUDA events)."""
        s = self.strategy
        loader = s._get_loader(FrameList(self.train_pool.labeled_data[:self.B * self.ctx.world]),
                               self.B)
        try:
            batch = next(iter(loader))
        finally:
            loader.close()
        images, gt = s._device_batch(batch, train=True)
        pvjv, fv = s._put(batch["per_view_joint_valid"]), s._put(batch["frame_valid"])
        state = self.state.clone()
        return self.ctx.time_ms(lambda: s.engine.train_step(state, images, gt, pvjv, fv),
                                int(self.t["probe_steps"]))

    def train(self, steps: int):
        cfg = self.cfg.clone()
        total = int(self.state.step) + steps
        cfg.TRAIN.OPTIM.TOTAL_STEPS = total
        cfg.TRAIN.LOG_EVERY_ITER = total
        return self.strategy._train(0, cfg, self.train_pool, self.val_pool, self.state)

    def install_spans(self, spans):
        s = self.strategy
        spans.wrap(s, "_train", "train")
        spans.wrap(s, "_device_batch", "device_prepare")
        spans.wrap(s, "_put", "to_device")
        spans.wrap(s.engine, "train_step", "train_step")
        spans.wrap(s, "_evaluate_all", "evaluate")
        spans.wrap(s, "_save_point", "checkpoint")

    def window(self, seconds: float) -> Dict:
        ctx = self.ctx
        step0, count0 = int(self.state.step), int(self.state.count)
        ctx.sync()
        ctx.barrier("window")
        t0 = time.perf_counter()
        self.state = self.train(self.steps)
        ctx.sync()
        elapsed = time.perf_counter() - t0
        steps = int(self.state.step) - step0
        self.skipped = steps - (int(self.state.count) - count0)
        frames = steps * self.B * ctx.world
        self.window_info = {"frames": frames, "seconds": elapsed, "steps": steps,
                            "crops": frames * int(self.data["views"])}
        return {"train_frames_per_s": frames / elapsed}

    def attempted_failed(self):
        return self.window_info["steps"], self.skipped

    def probes(self) -> Dict:
        """The loader alone over this rank's frames (rank 0's on n cards),
        and the bare step, whose collectives every rank meets."""
        s = self.strategy
        out = {}
        if self.ctx.rank == 0:
            loader = s._get_loader(self.train_pool, self.B)
            t0, n = time.perf_counter(), 0
            try:
                for batch in loader:
                    n += int(np.sum(batch["frame_valid"]))
            finally:
                loader.close()
            out["loader_frames_per_s"] = n / (time.perf_counter() - t0)
        out["train_step_ms"] = self._step_ms()
        return out

    def release(self):
        self._restore_step()
        self.ctx.fault.remove()
        kept, state = self.kept_window, self.state
        if "flat" in kept:
            before = {part: _views(kept["flat"][part], getattr(state, part), state.flat[part])
                      for part in ("params", "buffers", "mu", "nu")}
            self.window_stage = {"before": before, "count": int(kept["count"]),
                                 "loss": float(kept["loss"]),
                                 "params": _views(kept["after"], state.params, state.flat["params"])}
        del self.strategy, self.state, self.kept_window
        self.ctx.end_ranks()
        self.ctx.free()

    # ------------------------------------------------------------------ check

    def reference_batches(self, indices=None):
        """The global batches of the `indices`-th steps of a ``_train`` call
        (the first steps by default) as the loaders feed them: the training
        order (``_order``), each of the n ranks reading every n-th frame of
        it (its shard), B at a time; the global batch is the ranks' batches
        in rank order, the same in every epoch and every call."""
        order = self._order()
        world = self.ctx.world
        shards = [order[r::world] for r in range(world)]
        size = int(self.data["image_size"])
        stride = int(self.ctx.cfg_value("POSE_ESTIMATOR.STRIDE"))
        sigma = float(self.ctx.cfg_value("DATA.SIGMA"))
        batches = []
        epoch = -(-len(shards[0]) // self.B)
        for step in (range(self.first) if indices is None else indices):
            step %= epoch
            frames = [f for shard in shards for f in shard[step * self.B:(step + 1) * self.B]]
            prep = ref_data.prepare_frames(frames, size,
                                           float(self.ctx.cfg_value("DATA.SCALE_BBOX")))
            images = torch.from_numpy(prep["images"]).to(self.ctx.device)
            B, V = images.shape[:2]
            kp = torch.from_numpy(prep["keypoints_2d"]).to(self.ctx.device)
            batches.append({
                "x": normalize_f32(images.reshape((B * V,) + images.shape[2:])),
                "target": training.gaussian_targets(kp, stride, size, sigma).reshape(
                    (B * V,) + (kp.shape[2], size // stride, size // stride)),
            })
        return batches

    def reference_run(self, fp8: bool = False, batches=None) -> Dict:
        batches = batches or self.reference_batches()
        lr = float(self.ctx.cfg_value("TRAIN.OPTIM.LR"))
        clip = float(self.ctx.cfg_value("TRAIN.LOSS_CLIP_VALUE"))
        remat = self.ctx.world > 1
        out = training.run_steps(self.model, self.weights, batches, lr, clip, fp8=fp8, remat=remat)
        if not fp8:
            # The configuration's own arithmetic, bf16, for the first step:
            # its heatmaps give the scale of honest rounding for these
            # weights, its first BatchNorm's statistics what bf16 computes.
            bf16 = training.run_steps(self.model, self.weights, batches[:1], lr, clip,
                                      dtype=torch.bfloat16, remat=remat)
            out["bf16_output"], out["bf16_first_stats"] = bf16["first_output"], bf16["first_stats"]
        return out

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared.  With `control`, the reference trained in
        float8 stands in for the program's steps."""
        batches = self.reference_batches()
        ref = self.reference_run(batches=batches)
        window = self.check_window(control)
        if control:
            low = self.reference_run(fp8=True, batches=batches)
            got = {"losses": low["losses"], "grad": low["first_grad"],
                   "heatmap": low["first_output"], "params": low["params"],
                   "stats": low["stats"], "first_stats": low["first_stats"]}
        else:
            k = self.kept
            got = {"losses": [float(v) for v in k["losses"][:self.first]],
                   "grad": {n: m / (1 - training.ADAM_B1) for n, m in k["mu"].items()},
                   "heatmap": k["first_heatmap"], "params": k["params"], "stats": k["buffers"],
                   "first_stats": k["first_stats"]}
        return dict(compare_training(ref, got, self.weights), **window)

    def check_window(self, control: bool = False) -> Dict[str, float]:
        """The window's last step, followed from the program's own state
        before it: the reference takes that state (weights, BatchNorm
        statistics, Adam's moments and count) and the step's batch, which
        it makes itself, and steps once in float32 (with `control`, also in
        float8, in the program's place).  window_loss_gap: the step's
        relative loss gap; window_update_gap_median: the median leaf's gap
        of norms of the parameters' change (``_leaf_gaps``), leaves whose
        reference gradient is under 1e-3 of the median's left out."""
        stage = getattr(self, "window_stage", None)
        if stage is None:
            return {"window_loss_gap": float("inf"), "window_update_gap_median": float("inf")}
        before = stage["before"]
        start = {**before["params"], **before["buffers"]}
        adam = (before["mu"], before["nu"], stage["count"])
        batch = self.reference_batches([self.steps - 1])
        lr = float(self.ctx.cfg_value("TRAIN.OPTIM.LR"))
        clip = float(self.ctx.cfg_value("TRAIN.LOSS_CLIP_VALUE"))
        remat = self.ctx.world > 1
        ref = training.run_steps(self.model, start, batch, lr, clip, adam=adam, remat=remat)
        loss, params = stage["loss"], stage["params"]
        if control:
            low = training.run_steps(self.model, start, batch, lr, clip, fp8=True, adam=adam,
                                     remat=remat)
            loss, params = low["losses"][0], low["params"]
        norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref["first_grad"].items()}
        median = float(np.median(list(norms.values())))
        moved = [n for n in norms if norms[n] >= 1e-3 * median]
        p0 = before["params"]
        gaps = _leaf_gaps({n: ref["params"][n] - p0[n] for n in moved},
                          {n: params[n].to(p0[n].device) - p0[n] for n in moved}, moved)
        r = ref["losses"][0]
        return {"window_loss_gap": abs(loss - r) / max(abs(r), 1e-30),
                "window_update_gap_median": float(np.median(gaps))}


def _views(flat: torch.Tensor, named: Dict[str, torch.Tensor], base: torch.Tensor):
    """`named`'s views of `base`, laid over `flat`, a copy of `base`."""
    at = base.storage_offset()
    return {n: flat.narrow(0, t.storage_offset() - at, t.numel()).view(t.shape)
            for n, t in named.items()}


def _leaf_gaps(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor], names) -> np.ndarray:
    """Per leaf: |‖got‖ - ‖ref‖| over the larger of the leaf's reference
    norm and the median leaf's."""
    names = list(names)
    if not names:
        return np.zeros(1)
    r = torch.stack([torch.linalg.vector_norm(ref[n].double()) for n in names])
    g = torch.stack([torch.linalg.vector_norm(got[n].double().to(ref[n].device)) for n in names])
    floor = torch.median(r)
    return (torch.abs(g - r) / torch.clamp(torch.maximum(r, floor), min=1e-300)).cpu().numpy()


def _relative(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float(torch.linalg.vector_norm(got.double().to(ref.device) - ref)
                 / torch.clamp(torch.linalg.vector_norm(ref), min=1e-300))


def _batch_stats(first: Dict[str, torch.Tensor], initial: Dict[str, torch.Tensor], names):
    momentum = training.BN_MOMENTUM
    return {n: (first[n].double().to(initial[n].device) - (1 - momentum) * initial[n].double())
            / momentum for n in names}


def compare_training(ref: Dict, got: Dict, initial: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """loss_gap: the worst step's relative loss gap; grad_gap /
    update_gap / bn_stat_gap: the worst leaf's norm gap (``_leaf_gaps``) of
    the first gradient, of each parameter's change and of each BN
    statistic's change, and ``*_median`` the median leaf's (``worst_leaf``
    names the worst, for the record); stem_stat_gap: the first
    BatchNorm's two batch statistics in the first step against the bf16
    reference's, the worse ‖got - ref‖ / ‖ref‖; heatmap_gap: the first crop's first-step
    heatmaps, ‖got - ref‖ / ‖ref‖, and heatmap_excess that over a plain
    bf16 reference's own."""
    if len(got["losses"]) < len(ref["losses"]):
        loss_gap = float("inf")
    else:
        loss_gap = max(abs(g - r) / max(abs(r), 1e-30) for g, r in zip(got["losses"], ref["losses"]))
    grads = ref["first_grad"]
    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grads.items()}
    median = float(np.median(list(norms.values())))
    # Leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: their change is not compared.
    moved = [n for n in grads if norms[n] >= 1e-3 * median]
    change = {n: ref["params"][n] - initial[n] for n in moved}
    got_change = {n: got["params"][n].to(initial[n].device) - initial[n] for n in moved}
    stat_change = {n: ref["stats"][n] - initial[n] for n in ref["stats"]}
    got_stat = {n: got["stats"][n].to(initial[n].device) - initial[n] for n in ref["stats"]}
    out = {"loss_gap": loss_gap, "worst_leaf": {}}
    for name, (a, b, names) in {"grad_gap": (grads, got["grad"], grads),
                                "update_gap": (change, got_change, moved),
                                "bn_stat_gap": (stat_change, got_stat, stat_change)}.items():
        gaps = _leaf_gaps(a, b, names)
        out[name], out[name + "_median"] = float(np.max(gaps)), float(np.median(gaps))
        out["worst_leaf"][name] = list(names)[int(np.argmax(gaps))] if len(names) else ""
    # The first step's batch statistics of the BatchNorm nearest the input
    # (the first in module order), read back from the running averages
    # (ra1 - 0.9 ra0) / 0.1: the crops the step saw, through one conv in
    # the configuration's bf16, before any update (deeper statistics and
    # later steps carry the chaotic growth of a random-init BN net's
    # rounding differences).  Against the bf16 reference's, by the norm of
    # the difference, the worse of the two.
    stem = list(ref["first_stats"])[:2]
    a = _batch_stats(ref["bf16_first_stats"], initial, stem)
    b = _batch_stats(got["first_stats"], initial, stem)
    out["stem_stat_gap"] = max(float(torch.linalg.vector_norm(b[n] - a[n])
                                     / torch.clamp(torch.linalg.vector_norm(a[n]), min=1e-300))
                               for n in stem)
    h_ref = ref["first_output"].double()
    out["heatmap_gap"] = _relative(got["heatmap"], h_ref)
    if "bf16_output" in ref:
        # The first crop's step-1 heatmaps against float32, over how far a
        # plain bf16 computation of the reference lands from float32 on the
        # same weights and crops: about 1 for bf16 arithmetic, whatever
        # the seed's sensitivity; more for coarser arithmetic.
        out["heatmap_excess"] = out["heatmap_gap"] / max(_relative(ref["bf16_output"], h_ref),
                                                         1e-300)
    return out


def min_seconds_per_frame(ctx) -> float:
    """The least time the cell's cards take on one trained frame: forward
    and backward counted as 3x the forward's operations, all at the bf16
    peak, shared by the cards."""
    data = ctx.config["data"]
    macs = counting.forward_macs(ctx.config["model"], int(data["image_size"]))
    return 3.0 * 2.0 * sum(macs.values()) / ctx.peaks["bf16"] * int(data["views"]) / ctx.world


CELL = TrainCell


def run(ctx) -> Dict:
    return ctx.drive(CELL(ctx))
