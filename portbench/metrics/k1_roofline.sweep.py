"""k1_roofline.sweep: K1 (the fused decode, csrc/decode.cu) against its
memory bound: the bytes of a launch's float32 heatmap rows and packed
results, counted from shapes, at the HBM peak, over the mean device time
of a launch in the traced window.  Moves sweep_frames_per_s."""

NAMES = ("decode_bulk_kernel", "decode_ragged_kernel")


def read(r):
    if r.kind != "sweep" or r.trace is None:
        return None
    seconds = launches = 0
    for name, (s, n) in r.trace["kernels"].items():
        if any(k in name for k in NAMES):
            seconds, launches = seconds + s, launches + n
    if not launches or seconds <= 0:
        return None
    batch = int(r.ctx.cfg_value("AL.INFERENCE.BATCH_SIZE"))
    bound = r.module.k1_bytes(r.ctx, batch) / r.ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / (seconds / launches)
