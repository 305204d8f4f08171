"""Faults planted under a cell's timed path, for the tests and the readings
that show the correctness check catches them.  Never installed by
``run.py``.

Each fault replaces one callable of the program while the cell runs:

  * ``unchanged_state`` (train): the step computes, and returns its state
    as it was;
  * ``half_batch`` (train, sweep): the step sees the first half of the
    batch's frames (the loss and gradient are their mean; the sweep's
    heatmaps for the other half are copies of the first half's);
  * ``answer_altered`` (train, sweep): answers changed where they are made
    (train: the loss each step returns, half again; sweep: each frame's AL
    metric, as the score step returns it, 1% higher);
  * ``keypoint_altered`` (sweep): each batch's first keypoint moved by one
    stride in K1's output;
  * ``gradient_not_exchanged`` (train on more than one card): rank 0 steps
    on its own share of the gradient and of the loss, the sum over the
    ranks left out;
  * ``bn_local`` (train on more than one card): rank 0's BatchNorms
    normalize by, and keep, the statistics of its own rows.

The two faults of a multi-card cell are planted in rank 0 alone, which
still takes its part in each collective (the other ranks would otherwise
wait on it) and drops what it receives.
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Tuple

KINDS = {"train": ("unchanged_state", "half_batch", "answer_altered"),
         "sweep": ("half_batch", "answer_altered", "keypoint_altered")}
# A training cell on more than one card has these besides.
RANKS = ("gradient_not_exchanged", "bn_local")


class _Parallel:
    """The program's ``parallel`` module as one of its modules sees it,
    with ``all_reduce_sum`` replaced."""

    def __init__(self, module, all_reduce_sum):
        self._module = module
        self.all_reduce_sum = all_reduce_sum

    def __getattr__(self, name):
        return getattr(self._module, name)


def _local_sums(keep_sum=lambda t: False):
    """A ``parallel`` whose sums meet the collective with a copy and return
    this rank's own values, except where `keep_sum(t)`."""
    def make(parallel):
        def all_reduce_sum(t, group=None):
            if keep_sum(t):
                return parallel.all_reduce_sum(t, group)
            parallel.all_reduce_sum(t.clone(), group)
            return t
        return _Parallel(parallel, all_reduce_sum)
    return make


class Faults:
    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self._undo: List[Tuple[object, str, object]] = []

    def _patch(self, owner, attr, make):
        original = getattr(owner, attr)
        setattr(owner, attr, make(original))
        self._undo.append((owner, attr, original))

    def install(self, cell) -> None:
        engine = cell.strategy.engine
        for name in self.names:
            getattr(self, "_" + name)(cell, engine)

    def remove(self) -> None:
        for owner, attr, original in reversed(self._undo):
            setattr(owner, attr, original)
        self._undo.clear()

    # -- train -----------------------------------------------------------------

    def _unchanged_state(self, cell, engine):
        if hasattr(cell, "capture"):
            raise ValueError("unchanged_state is a training fault")

        def make(original):
            def step(state, *args):
                _, metrics = original(state.clone(), *args)
                return state, metrics
            return step
        self._patch(engine, "train_step", make)

    def _half_batch(self, cell, engine):
        if hasattr(cell, "capture"):  # sweep: the forward sees half the frames
            def make_forward(original):
                def forward(images, *args, **kwargs):
                    half = max(1, images.shape[0] // 2)
                    out = original(images[:half], *args, **kwargs)
                    reps = -(-images.shape[0] // half)
                    return out.repeat((reps,) + (1,) * (out.dim() - 1))[:images.shape[0]]
                return forward
            self._patch(engine, "forward", make_forward)
            return

        def make(original):
            def step(state, images, gt, pvjv, frame_valid):
                half = max(1, images.shape[0] // 2)
                return original(state, images[:half], gt[:half], pvjv[:half], frame_valid[:half])
            return step
        self._patch(engine, "train_step", make)

    def _answer_altered(self, cell, engine):
        if hasattr(cell, "capture"):  # sweep: the AL metric as scored
            def make_score(original):
                def score_step(*args, **kwargs):
                    out = original(*args, **kwargs)
                    out["al_metric"] = out["al_metric"] * 1.01
                    return out
                return score_step
            self._patch(engine, "score_step", make_score)
            return

        def make(original):
            def step(state, *args):
                state, metrics = original(state, *args)
                return state, dict(metrics, loss=metrics["loss"] * 1.5)
            return step
        self._patch(engine, "train_step", make)

    def _gradient_not_exchanged(self, cell, engine):
        # The step's one large sum is the flat gradient with the loss; the
        # loss's counts (one or two numbers) are still summed.
        self._patch(sys.modules[type(engine).__module__], "parallel",
                    _local_sums(lambda t: t.numel() <= 2))

    def _bn_local(self, cell, engine):
        from multi_view_active_learning_tpu_torch.models import layers

        self._patch(layers, "parallel", _local_sums())

    def _keypoint_altered(self, cell, engine):
        if not hasattr(cell, "capture"):
            raise ValueError("keypoint_altered is a sweep fault")

        def make_decode(original):
            def decode(*args, **kwargs):
                out = original(*args, **kwargs)
                coords = out[0] if isinstance(out, tuple) else out
                coords[(0,) * (coords.dim() - 1)] += float(args[1])
                return out
            return decode
        self._patch(cell.capture, "original", make_decode)
