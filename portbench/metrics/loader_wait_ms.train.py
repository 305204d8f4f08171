"""loader_wait_ms.train: the host's wait for the training loader's next
batch a step in the traced window's ``_train`` call, in ms: the
program's ``train.loader_wait`` spans inside ``train`` over the steps
(one ``train.step`` span a step).  Moves train_frames_per_s."""

import program_spans


def value(records):
    found = program_spans.inside(records, "train", "train.step")
    if found is None:
        return None
    spans, steps = found
    return 1e3 * spans.seconds("train.loader_wait") / steps


def read(r):
    return value(program_spans.records()) if r.kind == "train" else None
