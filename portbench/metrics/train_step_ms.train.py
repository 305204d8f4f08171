"""train_step_ms.train: Engine.train_step on a batch already on the card, on
a copy of the state, CUDA events over several steps after a warm-up.
Moves train_frames_per_s."""


def read(r):
    return r.probes.get("train_step_ms") if r.kind == "train" else None
