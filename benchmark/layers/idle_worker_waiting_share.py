"""idle_worker_waiting_share (device): of the device's idle time in the
profiled sub-window, the share during which the dispatch worker ran no
job (the trace's idle gaps outside the program's ``dispatch.job``
spans, placed on the trace's clock)."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    busy = program.idle_in(run, "dispatch.job")
    return None if busy is None else 1.0 - busy
