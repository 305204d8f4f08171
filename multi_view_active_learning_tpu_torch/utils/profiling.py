"""Tracing, host spans, step timing and device memory.

The port's counterpart of the JAX package's utils/profiling.py: `trace`
records a ``torch.profiler`` trace of a block (the host and, on a card,
CUDA activity) into a directory, `StepTimer` keeps steps/s and p50 / p95
step latency over a window of ticks, and `device_memory_stats` reads the
CUDA caching allocator (the reference logs torch.cuda.memory_reserved,
strategy.py:533-542).  None of the three waits for the card between log
points.

Spans: `span(name)` marks a block of the program's host work.  It records
only while a ``torch.profiler`` session is active (one C call decides; off,
a span site allocates nothing); then it keeps a record, `SpanRecord`, on
``time.perf_counter_ns``, and opens a ``record_function`` of the same name,
so a Chrome trace shows the span on the kernels' timeline.
`spanned(name)` makes a whole function such a span.  `span_records()`
returns the records since `clear_spans()` (`trace` clears them on entry).
While spans record, the host's waits for the card are charged to the
innermost open span, and `host_waits()` sums them: synchronizing calls
that torch's sync debug mode flags (the outermost span turns the mode to
"warn" and restores it on exit) and the explicit waits of `wait(event)`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import warnings
from collections import deque
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

SYNC_WARNING = "called a synchronizing CUDA operation"

_profiler_enabled = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CUDA activity
    too when a card is present) and write a Chrome trace,
    ``<log_dir>/trace-<pid>.json``, that Perfetto and TensorBoard read.
    The block's spans are those of `span_records()` after it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace-%d.json" % os.getpid()))


class SpanRecord(NamedTuple):
    """One span: its `name`, start and end on ``time.perf_counter_ns``
    (`end_ns` -1 while open), the index of the enclosing span (`parent`,
    -1 for none) and of the outermost one (`root`, its own index for an
    outermost span), and the host's waits charged to it and not to a span
    inside it: `syncs` flagged by the sync debug mode, `events` waited
    through `wait`."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    syncs: int
    events: int


# Record fields while a span is open: a list, filled in at exit.
_NAME, _START, _END, _PARENT, _ROOT, _SYNCS, _EVENTS = range(7)


class _Recorder:
    """The process's span records, the stack of open spans and the sync
    debug state the outermost span saved."""

    def __init__(self):
        self.records: List[list] = []
        self.open: List[int] = []
        self.saved = None  # (sync debug mode, showwarning, filter) to restore

    def charge(self, field: int) -> None:
        self.records[self.open[-1]][field] += 1

    def showwarning(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            if self.open:
                self.charge(_SYNCS)
            return
        self.saved[1](message, category, filename, lineno, file, line)

    def sync_debug_on(self) -> None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        mode = torch.cuda.get_sync_debug_mode()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        self.saved = (mode, warnings.showwarning, warnings.filters[0])
        warnings.showwarning = self.showwarning
        torch.cuda.set_sync_debug_mode("warn")

    def sync_debug_off(self) -> None:
        if self.saved is None:
            return
        mode, showwarning, entry = self.saved
        torch.cuda.set_sync_debug_mode(mode)
        warnings.showwarning = showwarning
        if entry in warnings.filters:
            warnings.filters.remove(entry)
            warnings._filters_mutated()
        self.saved = None


_recorder = _Recorder()


class _Span:
    __slots__ = ("name", "function")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _recorder
        if not rec.open:
            rec.sync_debug_on()
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        index = len(rec.records)
        parent = rec.open[-1] if rec.open else -1
        root = rec.records[parent][_ROOT] if rec.open else index
        rec.records.append([self.name, time.perf_counter_ns(), -1, parent, root, 0, 0])
        rec.open.append(index)

    def __exit__(self, *exc):
        rec = _recorder
        rec.records[rec.open.pop()][_END] = time.perf_counter_ns()
        self.function.__exit__(*exc)
        if not rec.open:
            rec.sync_debug_off()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager: the block is a span named `name` while a
    ``torch.profiler`` session is active, and nothing more otherwise."""
    return _Span(name) if _profiler_enabled() else _OFF


def spanned(name: str):
    """A decorator: each call of the function is a span named `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def span_each(name: str, iterable: Iterable) -> Iterator:
    """Iterates `iterable`, each of its steps (the wait for its next item)
    a span named `name`."""
    it = iter(iterable)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def wait(event) -> None:
    """The host waits until the card has passed `event` (a CUDA event),
    a wait charged to the innermost open span."""
    if _recorder.open:
        _recorder.charge(_EVENTS)
    event.synchronize()


def span_records() -> List[SpanRecord]:
    """The spans recorded since `clear_spans`, in the order they opened."""
    return [SpanRecord(*r) for r in _recorder.records]


def host_waits() -> int:
    """The host's waits for the card in the spans since `clear_spans`."""
    return sum(r[_SYNCS] + r[_EVENTS] for r in _recorder.records)


def clear_spans() -> None:
    """Drops the records; call it outside any span."""
    _recorder.records.clear()


class StepTimer:
    """steps/s and p50 / p95 step time over the last `window` steps, from
    the time between consecutive `tick`s.  On a CUDA `device` a tick
    records an event on the current stream and does not wait, so the times
    are the card's step period; `summary` reads them, waiting for the last
    tick's event (at a log point, after the loss read, it has passed).  On
    the CPU the ticks read the host clock."""

    def __init__(self, window: int = 200, device: Optional[torch.device] = None):
        self.window = window
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._marks: deque = deque(maxlen=window + 1)

    def tick(self) -> None:
        if self._cuda:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        else:
            mark = time.perf_counter()
        self._marks.append(mark)

    def summary(self) -> Dict[str, float]:
        if len(self._marks) < 2:
            return {}
        marks = list(self._marks)
        if self._cuda:
            wait(marks[-1])
            d = np.asarray([a.elapsed_time(b) * 1e-3 for a, b in zip(marks, marks[1:])])
        else:
            d = np.diff(np.asarray(marks))
        return {
            "steps_per_sec": 1.0 / float(d.mean()),
            "step_ms_p50": float(np.percentile(d, 50) * 1e3),
            "step_ms_p95": float(np.percentile(d, 95) * 1e3),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{"cuda:i": {bytes_in_use_gib, peak_bytes_in_use_gib, bytes_limit_gib}}
    from torch.cuda.memory_stats, for each card once this process has
    initialized CUDA; {} before that or without CUDA."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    gib = 1024**3
    out: Dict[str, Dict[str, float]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        out["cuda:%d" % i] = {
            "bytes_in_use_gib": stats.get("allocated_bytes.all.current", 0) / gib,
            "peak_bytes_in_use_gib": stats.get("allocated_bytes.all.peak", 0) / gib,
            "bytes_limit_gib": torch.cuda.get_device_properties(i).total_memory / gib,
        }
    return out
