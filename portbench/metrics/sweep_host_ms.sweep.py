"""sweep_host_ms.sweep: the host's time a batch in the traced window's
sweeps outside its waits for frames and for outputs, in ms: the program's
``sweep`` spans less their ``sweep.loader_wait`` and ``fetch_wait`` spans,
over the batches (one ``sweep.dispatch`` span a batch).  Launches that
block while the card's launch queue is full count here: while the sweep is
device-bound this reads the device's batch time less the fetch wait, and
it reads the host's own work a batch only once the card outruns the host.
Moves sweep_frames_per_s."""

import program_spans


def value(records):
    found = program_spans.inside(records, "sweep", "sweep.dispatch")
    if found is None:
        return None
    spans, batches = found
    host = spans.seconds("sweep") - spans.seconds("sweep.loader_wait") - spans.seconds("fetch_wait")
    return 1e3 * host / batches


def read(r):
    return value(program_spans.records()) if r.kind == "sweep" else None
