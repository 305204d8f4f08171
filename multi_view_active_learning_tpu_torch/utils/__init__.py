"""Shared utilities: logging and small host-side helpers.

The port's own copy of the JAX package's utils/__init__.py (reference:
utils/__init__.py:15-84, a colorlog logger with rank-gated levels and a
tqdm bridge).  The loggers of a rank other than 0 log at WARNING.
"""

import logging
import sys
import time

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_ROOT = "mval_torch"
_configured = False


def _rank() -> int:
    """This process's rank once a process group exists, else 0.  Only
    consulted when torch.distributed is already imported: the decode
    workers import this module and never torch."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_logger(name: str = "mval_torch", level: int = logging.INFO) -> logging.Logger:
    """A logger under the port's root, which writes to stderr; at WARNING
    on a rank other than 0 (the port's loggers inherit the root's level,
    so one call after the group is made gates them all)."""
    global _configured
    root = logging.getLogger(_ROOT)
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    if _rank() != 0:
        root.setLevel(logging.WARNING)
    return logging.getLogger(_ROOT + "." + name)


class RateLogger:
    """Periodic progress lines for long sweeps (the role the reference
    fills by bridging tqdm into its logger): at most one line per
    `interval` seconds,

        scored 1280/8448 frames (15.2%, 212.3 frames/s)

    Call `tick(n)` per item (or batch, with n=items); the sweep's own
    summary line is the final word."""

    def __init__(self, logger, verb: str, total: int, unit: str = "frames",
                 interval: float = 15.0):
        self._logger = logger
        self._verb = verb
        self._total = int(total)
        self._unit = unit
        self._interval = interval
        self._t0 = time.monotonic()
        self._last = self._t0
        self._count = 0

    def tick(self, n: int = 1) -> None:
        self._count += int(n)
        now = time.monotonic()
        if now - self._last < self._interval or self._count >= self._total:
            return
        self._last = now
        rate = self._count / max(now - self._t0, 1e-9)
        pct = 100.0 * self._count / max(self._total, 1)
        self._logger.info(
            "%s %d/%d %s (%.1f%%, %.1f %s/s)"
            % (self._verb, self._count, self._total, self._unit, pct, rate,
               self._unit)
        )
