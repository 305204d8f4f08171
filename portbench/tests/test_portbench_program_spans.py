"""The readers of the program's own spans and wait counts: each metric's
arithmetic on a hand-made record list, and None where the program keeps
no records (a checkout before them) or the window holds none of the
metric's spans."""

import types

import pytest

import harness
import program_spans
from multi_view_active_learning_tpu_torch.utils.profiling import SpanRecord

MS = 1_000_000  # ns


def _span(name, start_ms, end_ms, parent=-1, root=0, syncs=0, events=0):
    return SpanRecord(name, start_ms * MS, end_ms * MS, parent, root, syncs, events)


def _sweep(first=0):
    """A sweep of two batches: loader waits 2 + 1 ms, fetch waits 30 + 40 ms
    (one of them under a nested span, one with a synchronizing call), and
    a sweep 100 ms long; then a span outside any sweep."""
    r = first
    return [
        _span("sweep", 0, 100, root=r),
        _span("sweep.loader_wait", 1, 3, r, r),
        _span("sweep.dispatch", 3, 10, r, r),
        _span("sweep.loader_wait", 10, 11, r, r),
        _span("sweep.dispatch", 11, 20, r, r),
        _span("fetch_wait", 20, 50, r, r, events=1),
        _span("sweep.collect", 50, 55, r, r, syncs=1),
        _span("fetch_wait", 55, 95, r, r, events=1),
        _span("evaluate", 200, 300, root=first + 8),
        _span("fetch_wait", 210, 290, first + 8, first + 8, events=1),
    ]


def _train():
    """Two steps (200 ms and 300 ms in train.step, loader waits of 5 and
    7 ms), then one log point of 2.5 s with an evaluation's fetch wait and
    two synchronizing calls."""
    return [
        _span("train", 0, 4000),
        _span("train.loader_wait", 0, 5, 0, 0),
        _span("train.prepare", 5, 20, 0, 0),
        _span("train.step", 20, 220, 0, 0),
        _span("engine.forward", 25, 120, 3, 0),
        _span("train.loader_wait", 220, 227, 0, 0),
        _span("train.step", 230, 530, 0, 0),
        _span("train.log_point", 540, 3040, 0, 0),
        _span("train.records", 540, 550, 7, 0, syncs=2),
        _span("evaluate", 550, 2000, 7, 0),
        _span("fetch_wait", 560, 600, 9, 0, events=1),
    ]


READINGS = [
    ("sweep_host_ms.sweep", "sweep", _sweep, (100 - 3 - 70) / 2),
    ("fetch_wait_ms.sweep", "sweep", _sweep, 70 / 2),
    ("host_waits.sweep", "sweep", _sweep, 3 / 2),
    ("step_host_ms.train", "train", _train, 500 / 2),
    ("loader_wait_ms.train", "train", _train, 12 / 2),
    ("log_point_s.train", "train", _train, 2.5),
    ("host_waits.train", "train", _train, 3 / 2),
]


@pytest.mark.parametrize("name,kind,make,expected", READINGS, ids=[r[0] for r in READINGS])
def test_reader_arithmetic(name, kind, make, expected, monkeypatch):
    reader = harness.metric_reader(name)
    monkeypatch.setattr(program_spans, "records", make)
    assert reader(types.SimpleNamespace(kind=kind)) == pytest.approx(expected)
    other = "train" if kind == "sweep" else "sweep"
    assert reader(types.SimpleNamespace(kind=other)) is None


@pytest.mark.parametrize("name", [r[0] for r in READINGS])
def test_reader_none_without_records(name, monkeypatch):
    reader = harness.metric_reader(name)
    kind = name.rsplit(".", 1)[1]
    for records in (None, [], [_span("evaluate", 0, 10)]):
        monkeypatch.setattr(program_spans, "records", lambda: records)
        assert reader(types.SimpleNamespace(kind=kind)) is None


def test_records_absent_from_a_program_without_spans(monkeypatch):
    from multi_view_active_learning_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_records")
    assert program_spans.records() is None
    monkeypatch.setattr(program_spans, "PROFILING", "no_such_package.profiling")
    assert program_spans.records() is None
