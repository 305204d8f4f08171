"""Operations and bytes counted from shapes (reference/counting.py)."""

import pytest

import harness
from reference import counting

CONFIGS = {name: harness.load_json("%s/configs/%s.json" % (harness.HERE, name))
           for name in ("prn50-panoptic", "hrnet-w32-panoptic")}


def test_hrnet_w32_forward_macs_match_the_published_count():
    """HRNet-W32: 7.1 G multiply-adds at 256x192 (Sun et al., Table 1),
    4/3 of that at 256x256."""
    macs = counting.forward_macs(CONFIGS["hrnet-w32-panoptic"]["model"], 256)
    assert sum(macs.values()) == pytest.approx(7.1e9 * 4 / 3, rel=0.10)
    assert macs["deconv"] == 0


def test_pose_resnet50_trunk_and_head():
    """The ResNet-50 trunk: 3.8 G multiply-adds at 224x224 (He et al.,
    Table 1).  The head's transposed convs count k*k*Cin*Cout per input
    pixel: 2048 -> 256 at 8x8, then 256 -> 256 at 16x16 and 32x32."""
    model = CONFIGS["prn50-panoptic"]["model"]
    assert counting.forward_macs(model, 224)["conv"] == pytest.approx(3.8e9, rel=0.10)
    macs = counting.forward_macs(model, 256)
    assert macs["deconv"] == 16 * 256 * (2048 * 64 + 256 * 256 + 256 * 1024)
    assert macs["final"] == 256 * 19 * 64 * 64


def test_k1_bytes_from_shapes():
    """A 16-frame scoring batch: 16 x 31 x 19 rows of 64 x 64 float32 maps
    read once, packed [rows, 8] float32 results written once."""
    rows = 16 * 31 * 19
    assert counting.decode_bytes(rows, 64 * 64) == rows * (64 * 64 * 4 + 32)
    assert counting.decode_bytes(9424, 4096) == 154_704_384


def test_least_time_per_crop_uses_each_layer_precision():
    cfg = CONFIGS["prn50-panoptic"]
    peaks = harness.load_json(harness.HERE + "/peaks.json")["peaks"]
    t = counting.min_seconds_per_crop(cfg["model"], 256, cfg["precision"]["layers"], peaks)
    macs = counting.forward_macs(cfg["model"], 256)
    assert t == pytest.approx(2 * macs["conv"] / 1979e12 + 2 * macs["deconv"] / 989e12
                              + 2 * macs["final"] / 67e12)


@pytest.mark.parametrize("name,model_type", [("prn50-panoptic", "POSE_RESNET"),
                                             ("hrnet-w32-panoptic", "HRNET")])
def test_parameter_names_are_the_ports(name, model_type):
    """The seeded weights load into the port strictly: the benchmark's
    topology names every parameter and buffer the port's model has."""
    from multi_view_active_learning_tpu_torch.config import get_default_configs
    from multi_view_active_learning_tpu_torch.models import build_model

    _, params = counting.trace_model(CONFIGS[name]["model"], 64)
    cfg = get_default_configs()
    cfg.merge_from_dict(CONFIGS[name]["program"])
    state = build_model(cfg).state_dict()
    assert [(n, s) for n, s, _ in params.spec] == [(n, tuple(t.shape)) for n, t in state.items()]
