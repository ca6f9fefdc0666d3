"""idle_in_pack_share (device): of the device's idle time in the
profiled sub-window, the share during which the dispatch worker packed
a chunk (the intersection of the trace's idle gaps with the program's
``pack`` spans, placed on the trace's clock)."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    return program.idle_in(run, "pack")
