"""log_point_s.train: the seconds of a log point (evaluation, checkpoints,
the loss reads and the writer's records) in the traced window's
``_train`` call: the program's ``train.log_point`` spans inside
``train`` over their number.  Moves train_frames_per_s."""

import program_spans


def value(records):
    found = program_spans.inside(records, "train", "train.log_point")
    if found is None:
        return None
    spans, points = found
    return spans.seconds("train.log_point") / points


def read(r):
    return value(program_spans.records()) if r.kind == "train" else None
