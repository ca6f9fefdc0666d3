"""issue_cpu_share (P-frame encoder): the dispatch worker's CPU time over
the wall time of its launch issue of the window's chunks (the program's
``issue`` spans around ``encode_chunk``); under 1, the issuing thread
waited for the interpreter lock or a core."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    sp = program.window(run, "issue")
    wall = sum(s.t1 - s.t0 for s in sp)
    return sum(s.cpu for s in sp) / wall if wall else None
