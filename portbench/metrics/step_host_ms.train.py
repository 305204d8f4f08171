"""step_host_ms.train: the host's time in Engine.train_step a step in the
traced window's ``_train`` call, in ms: the program's ``train.step``
spans inside ``train`` over their number.  The enqueue of forward,
backward and update, the pace of a host-bound step (CUPTI's cost a
launch included).  Moves train_frames_per_s."""

import program_spans


def value(records):
    found = program_spans.inside(records, "train", "train.step")
    if found is None:
        return None
    spans, steps = found
    return 1e3 * spans.seconds("train.step") / steps


def read(r):
    return value(program_spans.records()) if r.kind == "train" else None
