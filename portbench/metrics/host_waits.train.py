"""host_waits.train: the host's waits for the card a step in the traced
window's ``_train`` call: the program's ``host_waits`` charged to spans
inside ``train`` (synchronizing calls and explicit event waits) over the
steps (one ``train.step`` span a step).  Moves train_frames_per_s."""

import program_spans


def value(records):
    found = program_spans.inside(records, "train", "train.step")
    if found is None:
        return None
    spans, steps = found
    return spans.waits() / steps


def read(r):
    return value(program_spans.records()) if r.kind == "train" else None
