"""k5_roofline.sweep: K5, the int8 conv unit (csrc/int8_conv.cu), against
its least time, in percent.  The least time of a forward's units, counted
from shapes by the configuration's topology (``UnitCounter`` below), is the
larger of 2 x their multiply-adds at the int8 peak and their least bytes at
the HBM peak: each unit's bf16 input read once, its s8 weights once, its
bf16 output written once and, where it takes the block's residual, that
bf16 residual read once.  The device time is every launch in the traced
window of K5's kernels, the quantize pre-pass included, matched by name;
the forwards in the window are the product kernel's launches over the
units a forward makes, each of the sweep's scoring batch (the calibration
runs on one).  A program without K5 reads nothing.  Moves
sweep_frames_per_s."""

import torch

from reference import arch, counting

PRODUCT = "k5_wgmma_kernel"
NAMES = (PRODUCT, "k5_quantize_kernel", "k5_im2col_kernel")


class UnitCounter(counting.MacCounter):
    """MacCounter that also keeps each conv unit's shapes: [cin, cout, k,
    input pixels, output pixels, takes the residual], a crop's."""

    def __init__(self):
        super().__init__()
        self.units = []
        self._outputs = []  # each unit's output, kept so that ids stay unique

    def unit(self, P, conv, bn, x, cin, cout, k, stride, relu):
        y = super().unit(P, conv, bn, x, cin, cout, k, stride, relu)
        self.units.append([cin, cout, k, x.shape[2] * x.shape[3], y.shape[2] * y.shape[3], False])
        self._outputs.append(y)
        return y

    def residual_relu(self, out, res):
        for i, y in enumerate(self._outputs):
            if y is out:  # the block's last conv takes the residual's add and ReLU
                self.units[i][5] = True
        return super().residual_relu(out, res)


def units_of(model, image_size: int):
    counter = UnitCounter()
    arch.forward(model, arch.Params(), counter,
                 torch.empty((1, 3, image_size, image_size), device="meta"))
    return counter.units


def least_seconds(units, crops: int, peaks) -> float:
    """The least time of one forward's units over `crops` crops."""
    macs = sum(k * k * cin * cout * hw_out for cin, cout, k, _, hw_out, _ in units) * crops
    nbytes = sum(crops * (2 * cin * hw_in + 2 * cout * hw_out * (2 if res else 1))
                 + cout * k * k * cin for cin, cout, k, hw_in, hw_out, res in units)
    return max(2.0 * macs / peaks["int8"], nbytes / peaks["hbm_bytes_per_s"])


def read(r):
    if r.kind != "sweep" or r.trace is None:
        return None
    seconds = products = 0
    for name, (s, n) in r.trace["kernels"].items():
        if any(k in name for k in NAMES):
            seconds += s
            if PRODUCT in name:
                products += n
    if not products or seconds <= 0:
        return None
    config = r.ctx.config
    units = units_of(config["model"], int(config["data"]["image_size"]))
    crops = int(r.ctx.cfg_value("AL.INFERENCE.BATCH_SIZE")) * int(config["data"]["views"])
    forwards = products / len(units)
    return 100.0 * least_seconds(units, crops, r.ctx.peaks) * forwards / seconds
