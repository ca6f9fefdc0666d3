"""dispatch_queue_ms_per_chunk (engine host): the mean time a chunk
dispatch waited in the dispatch worker's queue, from its submit on the
caller's thread to the start of its job on the worker (the program's
``dispatch.queued`` spans of the window's chunk dispatches)."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    items = {s.item for s in program.window(run, "issue")}  # chunks only
    q = [s for s in program.window(run, "dispatch.queued") if s.item in items]
    return program.ms(q) / len(q) if q else None
