"""device_idle.train: the share of the window's time in which no operation ran
on the card, in percent: one minus the device's busy seconds a frame in
the traced window (the same work, traced after it) over the window's
seconds a frame.  The profiler slows the host, not the device, so the
traced window's own length would overstate the idle share.  Moves
train_frames_per_s."""


def read(r):
    if (r.kind != "train" or r.trace is None or r.trace["busy_s"] <= 0
            or not r.traced_window or not r.window.get("frames")):
        return None
    busy = r.trace["busy_s"] / r.traced_window["frames"]
    return 100.0 * (1.0 - busy / (r.window["seconds"] / r.window["frames"]))
