"""loader_frames_per_s.train: frames per second of the program's training
FrameLoader over the cell's cached frames at its batch, iterated alone
after the window (host clock).  Moves train_frames_per_s."""


def read(r):
    return r.probes.get("loader_frames_per_s") if r.kind == "train" else None
