"""score_step_ms.sweep: Engine.score_step at the cell's batch on a batch
already on the card, its int8 scales calibrated on it, CUDA events over
many steps after a warm-up.  Moves sweep_frames_per_s."""


def read(r):
    return r.probes.get("score_step_ms") if r.kind == "sweep" else None
