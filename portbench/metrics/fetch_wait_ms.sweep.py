"""fetch_wait_ms.sweep: the host's wait for a batch's outputs in the traced
window's sweeps, in ms: the program's ``fetch_wait`` spans inside
``sweep`` over the batches (one ``sweep.dispatch`` span a batch).  The
device's lead over the host.  Moves sweep_frames_per_s."""

import program_spans


def value(records):
    found = program_spans.inside(records, "sweep", "sweep.dispatch")
    if found is None:
        return None
    spans, batches = found
    return 1e3 * spans.seconds("fetch_wait") / batches


def read(r):
    return value(program_spans.records()) if r.kind == "sweep" else None
