"""The benchmark's spans and the reduction of a profiler trace.

The traced window is profiled for the device's activity alone (kernels,
copies and sets); the profiler records no host operations, so its cost on
the host is CUPTI's alone and the traced window lasts about as long as an
untraced one.  The benchmark's spans are kept on the host's clock instead:
``Spans.wrap`` wraps a callable of the program so that, in a traced run,
each call is a span named ``bench.<name>``, the benchmark's own marks
around its calls into each layer; ``Spans.mark`` marks a block of the
benchmark's own, the window among them.  Untraced runs install no wrapper.
``Clock`` puts one small device operation before and one after the window,
each between two synchronizations, and so ties the host's clock to the
trace's.

Reduction (``reduce``): the device's operations inside the window, merged
into busy intervals; the busy seconds, the device time by kernel class,
the time and launches of named kernels, and the idle gaps between busy
intervals, each charged to the innermost benchmark span the host was in
when the device went idle.  ``kernel_class`` is a frozen copy of
tools/profile_scoring_torch.py::kernel_class, with copies, sets and
BatchNorm's kernels named and names matched without case, K5's kernels
(the int8 conv unit, csrc/int8_conv.cu) classed ``K5_int8_conv`` and
NCCL's collectives ``nccl``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

CLASSES = (
    ("K1_fused_decode", ("decode_bulk_kernel", "decode_ragged_kernel")),
    ("K2_min_distance", ("min_distance_kernel",)),
    ("convolution_cuDNN", ("fprop", "dgrad", "conv", "cudnn", "winograd")),
    ("matmul_cuBLAS", ("gemm", "imma", "xmma", "cutlass", "gemv", "sm90_")),
    ("batch_norm", ("batch_norm",)),
    ("copy_index_cat", ("copy", "cat", "index", "gather", "scatter", "pad")),
    ("pooling", ("max_pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


K5_KERNELS = ("k5_wgmma_kernel", "k5_quantize_kernel", "k5_im2col_kernel")


def kernel_class(name: str) -> str:
    squeezed = name.replace(" ", "")
    if any(k in squeezed for k in K5_KERNELS):
        return "K5_int8_conv"
    if "nccl" in name.lower():
        return "nccl"
    if "deconv_quantize_kernel" in squeezed or "deconv_wgmma_kernel<true" in squeezed:
        return "K4_fused_deconv_int8"
    if "deconv_wgmma_kernel" in squeezed or "deconv_f32_kernel" in squeezed:
        return "K3_fused_deconv"
    if name.startswith("Memcpy") or "memcpy" in name.lower():
        return "memcpy"
    if name.startswith("Memset") or "memset" in name.lower():
        return "memset"
    lowered = name.lower()  # CatArrayBatchedCopy is a copy too
    for label, keys in CLASSES:
        if any(k in lowered for k in keys):
            return label
    return "other"


class Spans:
    """Installs ``bench.<name>`` spans around program callables while a
    traced run lasts, and takes them out again.  `records` holds each span
    as (start ns, end ns, name) on ``time.perf_counter_ns``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records: List[Tuple[int, int, str]] = []
        self._undo: List[Tuple[object, str, object]] = []

    @contextlib.contextmanager
    def _span(self, name: str):
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            self.records.append((start, time.perf_counter_ns(), "bench." + name))

    def wrap(self, owner, attr: str, name: str, generator: bool = False) -> None:
        if not self.enabled:
            return
        original = getattr(owner, attr)

        if generator:
            @functools.wraps(original)
            def wrapped(*args, **kwargs):
                it = iter(original(*args, **kwargs))
                while True:
                    with self._span(name):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    yield item
        else:
            @functools.wraps(original)
            def wrapped(*args, **kwargs):
                with self._span(name):
                    return original(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, original))

    def remove(self) -> None:
        for owner, attr, original in reversed(self._undo):
            setattr(owner, attr, original)
        self._undo.clear()

    @contextlib.contextmanager
    def mark(self, name: str):
        if not self.enabled:
            yield
            return
        with self._span(name):
            yield


class Clock:
    """A marker operation on the device before (``__init__``) and after
    (``end``) the window, each between two synchronizations: the trace's
    first and last device operations, whose starts lie between the host
    times read around them."""

    def __init__(self, device):
        self.device = device
        self.marks = [self._mark()]

    def _mark(self) -> Tuple[int, int]:
        torch.cuda.synchronize(self.device)
        before = time.perf_counter_ns()
        torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        return before, time.perf_counter_ns()

    def end(self) -> None:
        self.marks.append(self._mark())


# Kineto's activity types of work on the device; its other device-side
# events (gpu_user_annotation, the host ranges mirrored on the device's
# timeline, and cuda_sync) span work and waits and are not operations.
# Where the event does not say its type, those are told by name.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
NOT_WORK = ("Sync", "Stream Wait")


def _is_device(event) -> bool:
    if event.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    annotation = getattr(event, "is_user_annotation", None)
    if annotation is not None and annotation():
        return False
    return not any(word in event.name() for word in NOT_WORK)


def reduce(prof, spans: List[Tuple[int, int, str]], clock: Clock, window: str = "bench.window",
           top: int = 10) -> Dict:
    """The window is the span named `window`.  Returns busy_s, window_s,
    device_ops (class -> seconds), kernels (name -> [seconds, launches]),
    idle_gaps (span -> seconds), the last two lists longest first, and
    clock_skew_us, how far the two marks' offsets between the host's clock
    and the trace's differ."""
    device = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if _is_device(e))
    if len(device) < 2:
        raise RuntimeError("the trace holds %d device operations" % len(device))
    # The marks' offsets: a device start against the middle of the host
    # times around it.
    offsets = [d[0] - (a + b) / 2 for d, (a, b) in zip((device[0], device[-1]), clock.marks)]
    shift = sum(offsets) / 2
    spans = sorted((int(a + shift), int(b + shift), name) for a, b, name in spans)
    marks = [(a, b) for a, b, name in spans if name == window]
    if not marks:
        raise RuntimeError("no %s span" % window)
    t0, t1 = marks[0]
    device = [(max(a, t0), min(b, t1), name) for a, b, name in device[1:-1] if b > t0 and a < t1]
    by_class: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    merged: List[List[int]] = []
    for start, end, name in device:
        by_class[kernel_class(name)] += (end - start) * 1e-9
        k = kernels[name]
        k[0] += (end - start) * 1e-9
        k[1] += 1
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = []
    edge = t0
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    idle: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in gaps:  # in time order; the host's spans nest
        while i < len(spans) and spans[i][0] <= a:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < a:
            stack.pop()
        idle[stack[-1][2] if stack else "outside_spans"] += (b - a) * 1e-9
    return {
        "busy_s": busy,
        "window_s": (t1 - t0) * 1e-9,
        "device_ops": sorted(by_class.items(), key=lambda kv: -kv[1])[:top],
        "kernels": dict(kernels),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:top],
        "gaps": len(gaps),
        "clock_skew_us": abs(offsets[1] - offsets[0]) * 1e-3,
    }
