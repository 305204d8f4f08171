"""mfu.sweep: the least time the chip could take on the operations of the
frames scored in the window (each layer at the peak of the precision it
runs in, counted from shapes by reference/counting.py), over the window's
time, in percent.  The window is the untraced one a traced run makes
before its traced one.  Moves sweep_frames_per_s."""


def read(r):
    if r.kind != "sweep" or not r.window.get("seconds"):
        return None
    least = r.module.min_seconds_per_frame(r.ctx) * r.window["frames"]
    return 100.0 * least / r.window["seconds"]
