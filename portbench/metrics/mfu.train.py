"""mfu.train: forward and backward operations of the frames trained in the
window, counted as 3x the forward's from shapes (no recomputation
counted), at the bf16 peak, over the window's time, in percent.  The
window is the untraced one a traced run makes before its traced one.
Moves train_frames_per_s."""


def read(r):
    if r.kind != "train" or not r.window.get("seconds"):
        return None
    least = r.module.min_seconds_per_frame(r.ctx) * r.window["frames"]
    return 100.0 * least / r.window["seconds"]
