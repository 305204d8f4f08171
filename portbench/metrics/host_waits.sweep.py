"""host_waits.sweep: the host's waits for the card a batch in the traced
window's sweeps: the program's ``host_waits`` charged to spans inside
``sweep`` (synchronizing calls and explicit event waits) over the batches
(one ``sweep.dispatch`` span a batch).  Moves sweep_frames_per_s."""

import program_spans


def value(records):
    found = program_spans.inside(records, "sweep", "sweep.dispatch")
    if found is None:
        return None
    spans, batches = found
    return spans.waits() / batches


def read(r):
    return value(program_spans.records()) if r.kind == "sweep" else None
