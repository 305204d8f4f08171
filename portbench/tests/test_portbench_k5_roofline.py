"""k5_roofline.sweep (portbench/metrics/k5_roofline.sweep.py): the units
counted from shapes, the least time, and the reading of a trace."""

import importlib.util
import os
import types

import pytest

import harness
from reference import counting

CONFIG = harness.load_json(os.path.join(harness.HERE, "configs", "prn50-panoptic.json"))
PEAKS = harness.load_json(os.path.join(harness.HERE, "peaks.json"))["peaks"]


def _metric():
    path = os.path.join(harness.HERE, "metrics", "k5_roofline.sweep.py")
    spec = importlib.util.spec_from_file_location("k5_roofline_sweep", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _readings(kernels, batch=16):
    ctx = types.SimpleNamespace(config=CONFIG, peaks=PEAKS,
                                cfg_value=lambda key: {"AL.INFERENCE.BATCH_SIZE": batch}[key])
    return types.SimpleNamespace(kind="sweep", trace={"kernels": kernels}, ctx=ctx)


def test_pose_resnet50_units():
    """53 convs, 16 of them a bottleneck's last (the residual's), their
    multiply-adds the trunk's conv count."""
    m = _metric()
    units = m.units_of(CONFIG["model"], 256)
    assert len(units) == 53 and sum(u[5] for u in units) == 16
    assert units[0] == [3, 64, 7, 256 * 256, 128 * 128, False]
    macs = sum(k * k * cin * cout * out for cin, cout, k, _, out, _ in units)
    assert macs == counting.forward_macs(CONFIG["model"], 256)["conv"]


def test_least_time_is_the_larger_bound():
    m = _metric()
    unit = [[64, 256, 1, 4096, 4096, True]]  # a residual unit of layer1, a crop
    crops = 496
    macs = 64 * 256 * 4096 * crops
    nbytes = crops * (2 * 64 * 4096 + 2 * 256 * 4096 * 2) + 256 * 64
    want = max(2 * macs / PEAKS["int8"], nbytes / PEAKS["hbm_bytes_per_s"])
    assert m.least_seconds(unit, crops, PEAKS) == pytest.approx(want, rel=1e-12)
    assert want == nbytes / PEAKS["hbm_bytes_per_s"]  # bytes bind at 1x1, Cin 64


def test_reading_of_a_trace():
    """Two forwards (106 product launches) in 40 ms of K5's kernels, the
    pre-pass included; other kernels are not counted."""
    m = _metric()
    kernels = {
        "void (anonymous namespace)::k5_wgmma_kernel<256>(CUtensorMap_st, ...)": [0.025, 60],
        "void (anonymous namespace)::k5_wgmma_kernel<64>(CUtensorMap_st, ...)": [0.005, 46],
        "void (anonymous namespace)::k5_quantize_kernel(__nv_bfloat16 const*, ...)": [0.008, 104],
        "void (anonymous namespace)::k5_im2col_kernel(__nv_bfloat16 const*, ...)": [0.002, 2],
        "void cudnn::something_conv_kernel(...)": [1.0, 6],
    }
    units = m.units_of(CONFIG["model"], 256)
    least = m.least_seconds(units, 16 * 31, PEAKS)
    got = m.read(_readings(kernels))
    assert got == pytest.approx(100.0 * least * 2 / 0.040)
    assert 0 < got < 100


def test_nothing_to_read_without_k5():
    m = _metric()
    assert m.read(_readings({"void decode_bulk_kernel(...)": [0.001, 16]})) is None
    assert m.read(types.SimpleNamespace(kind="sweep", trace=None)) is None
    assert m.read(types.SimpleNamespace(kind="train", trace={"kernels": {}})) is None
