"""The port's host spans, wait counter and step timer
(``utils/profiling.py``):

  * outside a ``torch.profiler`` session a span site keeps no record and
    enters no ``record_function``;
  * under a CPU profiler session a tiny pool sweep (2 batches) and a
    2-step ``_train`` with one log point record every span of their sites,
    each inside its parent's interval with the right parent, one
    ``sweep.dispatch`` a batch and one ``train.step`` a step;
  * ``wait`` and the synchronizing calls the sync debug mode flags are
    charged to the innermost span and summed by ``host_waits``; the mode
    is restored after the outermost span, also when it raises (CUDA's
    calls replaced by fakes: there is no card here);
  * ``StepTimer``: the host clock on the CPU, CUDA events on a card,
    recorded without a wait at each tick.
"""

import warnings

import pytest
import torch

from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.data import build_dataset
from multi_view_active_learning_tpu_torch.data.synthetic import generate_panoptic_tree
from multi_view_active_learning_tpu_torch.strategy import ActiveLearningStrategy
from multi_view_active_learning_tpu_torch.utils import metrics_writer, profiling

CPU = [torch.profiler.ProfilerActivity.CPU]

SWEEP_PARENTS = {"sweep.loader_wait": "sweep", "sweep.prepare": "sweep",
                 "sweep.int8_calibrate": "sweep", "sweep.dispatch": "sweep",
                 "fetch_wait": "sweep", "sweep.collect": "sweep"}
TRAIN_PARENTS = {"train.loader_wait": "train", "train.prepare": "train", "train.step": "train",
                 "engine.forward": "train.step", "engine.backward": "train.step",
                 "engine.update": "train.step", "train.log_point": "train",
                 "evaluate": "train.log_point", "checkpoint": "train.log_point",
                 "train.records": "train.log_point"}


@pytest.fixture(autouse=True)
def _no_spans_left():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 4 + 2 frame tree of 3 cameras and 4 joints, 32 px crops,
    PoseResNet-18 in float32: a strategy on the CPU and its state."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tree = generate_panoptic_tree(str(tmp_path_factory.mktemp("tree")), num_train_frames=4,
                                  num_val_frames=2, num_joints=4, num_cameras=3)
    cfg = get_default_configs()
    cfg.DATA.TYPE = "synthetic"
    cfg.DATA.SYNTHETIC_ROOT = tree
    cfg.DATA.NUM_JOINTS = 4
    cfg.DATA.INPUT_HEIGHT = cfg.DATA.INPUT_WIDTH = 32
    cfg.DATA.USE_NATIVE_LOADER = False
    cfg.DATA.EPOCH_SIZE = 0
    cfg.POSE_ESTIMATOR.NUM_LAYERS = 18
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_SCORING = False
    cfg.AL.STRATEGY = "TRIANGULATION"
    cfg.AL.INFERENCE.BATCH_SIZE = 2
    cfg.AL.INFERENCE.NUM_WORKERS = 0
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TRAIN.NUM_WORKERS = 0
    cfg.TRAIN.LOG_EVERY_ITER = 2
    cfg.TRAIN.OPTIM.TOTAL_STEPS = 2
    cfg.TRAIN.VAL_SIZE = 2
    cfg.LOG_DIR = str(tmp_path_factory.mktemp("logs"))
    cfg.EXPR_NAME = "spans"
    strategy = ActiveLearningStrategy(cfg, device="cpu")
    yield strategy, strategy.new_state()
    torch.set_num_threads(threads)


def _check_nesting(records, parents, top):
    by_name = {}
    for i, r in enumerate(records):
        by_name.setdefault(r.name, []).append(i)
        assert r.end_ns >= r.start_ns, r
        if r.name == top:
            assert r.parent == -1 and r.root == i
            continue
        p = records[r.parent]
        assert p.name == parents[r.name], (r.name, p.name)
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (r, p)
        assert r.root == p.root and records[r.root].name == top
    assert set(by_name) == set(parents) | {top}, sorted(by_name)
    return by_name


def test_no_records_outside_a_session(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered outside a profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        with profiling.span("b"):
            profiling.wait(Event())
        for _ in profiling.span_each("c", range(3)):
            pass
    assert profiling.spanned("d")(lambda x: x + 1)(2) == 3
    assert Event.waited == 1
    assert profiling.span_records() == []
    assert profiling.host_waits() == 0


def test_sweep_and_training_record_every_span(tiny, monkeypatch):
    monkeypatch.setattr(metrics_writer, "_try_tb", lambda log_dir: None)
    strategy, state = tiny
    cfg = strategy.al_cfg
    pool = build_dataset(cfg, "train")
    pool.resample_unlabeled_data()
    with torch.profiler.profile(activities=CPU) as prof:
        sal = strategy._compute_sal_dict(pool, state.clone())
    assert len(sal["al_metric"]) == 4
    sweep = profiling.span_records()
    by_name = _check_nesting(sweep, SWEEP_PARENTS, "sweep")
    assert len(by_name["sweep.dispatch"]) == 2 and len(by_name["sweep.collect"]) == 2
    # The spans reach the trace as record_function ranges.
    names = {e.name for e in prof.events()}
    assert {"sweep", "sweep.dispatch", "fetch_wait"} <= names

    profiling.clear_spans()
    train_pool, val_pool = build_dataset(cfg, "train"), build_dataset(cfg, "val")
    train_pool.label_all()
    with torch.profiler.profile(activities=CPU):
        state = strategy._train(0, cfg.clone(), train_pool, val_pool, state.clone())
    assert int(state.step) == 2
    records = profiling.span_records()
    by_name = _check_nesting(records, dict(TRAIN_PARENTS, fetch_wait="evaluate"), "train")
    assert len(by_name["train.step"]) == 2 and len(by_name["engine.backward"]) == 2
    assert len(by_name["train.log_point"]) == 1 and len(by_name["checkpoint"]) == 1


class _FakeCuda:
    """torch.cuda's sync debug calls as a card would answer them."""

    def __init__(self, monkeypatch):
        self.mode, self.calls = 0, []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.calls.append(mode)
        self.mode = {"warn": 1}.get(mode, mode)


def _sync():
    warnings.warn(profiling.SYNC_WARNING)


def test_waits_are_counted_and_charged_to_the_innermost_span(monkeypatch):
    cuda = _FakeCuda(monkeypatch)

    class Event:
        def synchronize(self):
            pass

    with torch.profiler.profile(activities=CPU):
        with profiling.span("outer"):
            assert cuda.mode == 1
            _sync()
            with profiling.span("inner"):
                profiling.wait(Event())
                _sync()
                _sync()
            profiling.wait(Event())
    assert cuda.mode == 0 and cuda.calls == ["warn", 0]
    outer, inner = profiling.span_records()
    assert (outer.syncs, outer.events, inner.syncs, inner.events) == (1, 1, 2, 1)
    assert inner.parent == 0 and inner.root == 0
    assert profiling.host_waits() == 5
    with pytest.warns(UserWarning, match="synchronizing"):  # not swallowed outside spans
        _sync()


def test_sync_debug_mode_restored_when_the_span_raises(monkeypatch):
    cuda = _FakeCuda(monkeypatch)
    cuda.mode = 2
    filters, showwarning = list(warnings.filters), warnings.showwarning
    with torch.profiler.profile(activities=CPU):
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    assert cuda.mode == 1 and warnings.showwarning is not showwarning
                    raise ValueError("inside a span")
        with profiling.span("again"):
            pass
    assert cuda.calls == ["warn", 2, "warn", 2] and cuda.mode == 2
    assert warnings.filters == filters and warnings.showwarning is showwarning
    assert [r.name for r in profiling.span_records()] == ["outer", "inner", "again"]
    assert all(r.end_ns >= r.start_ns for r in profiling.span_records())


def test_trace_clears_the_records(tmp_path):
    with torch.profiler.profile(activities=CPU):
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("inside"):
            pass
    assert [r.name for r in profiling.span_records()] == ["inside"]


def test_step_timer_host_clock(monkeypatch):
    now = iter([1.0, 1.1, 1.3, 1.6, 2.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(now))
    timer = profiling.StepTimer(window=3)
    assert timer.summary() == {}
    for _ in range(5):
        timer.tick()
    s = timer.summary()  # the last three steps: 0.2, 0.3, 0.4 s
    assert set(s) == {"steps_per_sec", "step_ms_p50", "step_ms_p95"}
    assert s["steps_per_sec"] == pytest.approx(1 / 0.3)
    assert s["step_ms_p50"] == pytest.approx(300.0)
    assert s["step_ms_p95"] == pytest.approx(390.0)


def test_step_timer_cuda_events_do_not_wait_at_a_tick(monkeypatch):
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at, self.synced = None, 0
            made.append(self)

        def record(self, stream=None):
            self.at = 10.0 * len(made) ** 2  # ms on the card's clock

        def synchronize(self):
            self.synced += 1

        def elapsed_time(self, end):
            return end.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    timer = profiling.StepTimer(device=torch.device("cuda", 0))
    for _ in range(3):
        timer.tick()
    assert sum(e.synced for e in made) == 0
    s = timer.summary()  # steps of 30 and 50 ms
    assert [e.synced for e in made] == [0, 0, 1]
    assert s["step_ms_p50"] == pytest.approx(40.0)
    assert s["steps_per_sec"] == pytest.approx(25.0)
