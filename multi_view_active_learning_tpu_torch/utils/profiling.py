"""Step timing and device memory for the training loop's log points.

The port's counterpart of the JAX package's utils/profiling.py: `StepTimer`
keeps steps/s and p50 / p95 step latency over a window of host-clock ticks,
and `device_memory_stats` reads the CUDA caching allocator (the reference
logs torch.cuda.memory_reserved, strategy.py:533-542).  Neither
synchronizes the card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self._durations: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._durations.append(now - self._last)
            if len(self._durations) > self.window:
                self._durations.pop(0)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._durations:
            return {}
        d = np.asarray(self._durations)
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
