"""The reduction of a trace: busy time, the window cut on the host's clock
tied to the trace's by the two marks, and idle gaps charged to the
innermost benchmark span the host was in."""

import types

import pytest
import torch

import tracing

CUDA = torch.autograd.DeviceType.CUDA


def _event(name, start, end, kind="kernel"):
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                                 device_type=lambda: CUDA, activity_type=lambda: kind)


def test_reduce_cuts_the_window_and_charges_gaps_to_spans():
    shift = 5_000_000  # the trace's clock runs this far ahead of the host's
    events = [_event("marker", 100 + shift, 110 + shift),
              _event("batch_norm_backward_kernel", 1000 + shift, 1400 + shift),
              _event("gemm", 1300 + shift, 1500 + shift),
              _event("Memcpy HtoD", 1800 + shift, 1900 + shift, "gpu_memcpy"),
              _event("cuda sync", 1500 + shift, 1800 + shift, "cuda_sync"),
              _event("marker", 2300 + shift, 2310 + shift)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    clock = types.SimpleNamespace(marks=[(90, 110), (2290, 2310)])
    spans = [(200, 2200, "bench.window"), (1500, 1800, "bench.to_device"),
             (1450, 1850, "bench.train_step")]
    out = tracing.reduce(prof, spans, clock)
    assert out["window_s"] == pytest.approx(2000e-9)
    assert out["busy_s"] == pytest.approx(600e-9)  # 1000-1500 merged, 1800-1900
    assert dict(out["device_ops"]) == pytest.approx({"batch_norm": 400e-9,
                                                     "matmul_cuBLAS": 200e-9, "memcpy": 100e-9})
    assert dict(out["idle_gaps"]) == pytest.approx({"bench.window": 800e-9 + 300e-9,
                                                    "bench.to_device": 300e-9})
    assert out["clock_skew_us"] == 0


@pytest.mark.parametrize("name,label", [
    ("void k5_wgmma_kernel<128, 256, true>(Plan)", "K5_int8_conv"),
    ("k5_quantize_kernel(QuantArgs)", "K5_int8_conv"),
    ("void k5_im2col_kernel<3>(Args)", "K5_int8_conv"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "nccl"),
    ("decode_bulk_kernel", "K1_fused_decode"),
    ("void at::native::batch_norm_collect_statistics_kernel<float>", "batch_norm")])
def test_kernel_classes(name, label):
    assert tracing.kernel_class(name) == label
