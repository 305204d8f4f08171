"""loader_frames_per_s.sweep: frames per second of the program's FrameLoader
over the cell's warm pool at its scoring batch, iterated alone after the
window (host clock).  Moves sweep_frames_per_s."""


def read(r):
    return r.probes.get("loader_frames_per_s") if r.kind == "sweep" else None
