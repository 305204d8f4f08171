"""The program's own spans and host-wait counts, for the per-layer metrics
that read them (``metrics/*_ms.*``, ``host_waits.*``, ``log_point_s.*``).

The port keeps them in ``utils/profiling.py`` while a ``torch.profiler``
session is active, which in a run is the traced window alone:
``records()`` after that window holds its spans, each with its name, its
start and end on ``time.perf_counter_ns``, the index of its parent and the
waits charged to it (``syncs`` flagged by the sync debug mode, ``events``
waited explicitly).  A program that keeps no such records gives None, and
so does every metric read from them.
"""

from __future__ import annotations

import importlib
from typing import List, Optional

PROFILING = "multi_view_active_learning_tpu_torch.utils.profiling"


def records() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    try:
        module = importlib.import_module(PROFILING)
    except ImportError:
        return None
    read = getattr(module, "span_records", None)
    return (read() or None) if read is not None else None


class Inside:
    """The spans inside those named `top` (those included)."""

    def __init__(self, records: list, top: str):
        inside: set = set()
        for i, r in enumerate(records):  # a span opens after its parent
            if r.name == top or (r.parent >= 0 and r.parent in inside):
                inside.add(i)
        self.spans: List = [records[i] for i in sorted(inside)]

    def count(self, name: str) -> int:
        return sum(1 for r in self.spans if r.name == name)

    def seconds(self, name: str) -> float:
        return sum(r.end_ns - r.start_ns for r in self.spans if r.name == name) * 1e-9

    def waits(self) -> int:
        return sum(r.syncs + r.events for r in self.spans)


def inside(records: Optional[list], top: str, unit: str):
    """(`Inside(records, top)`, the number of its spans named `unit`), or
    None without records or without a span named `unit`."""
    if not records:
        return None
    spans = Inside(records, top)
    n = spans.count(unit)
    return (spans, n) if n else None
