"""caller_wait_ms_per_frame (engine host): the time the caller's thread
waited in the window, for the dispatch worker (``wait.dispatch``), for
the card's copies of the packed levels (``wait.card``) and for the
entropy pool (``wait.entropy``), over the window's frames (the
program's spans)."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    waits = program.window(run, "wait.dispatch", "wait.card",
                           "wait.entropy")
    return program.ms(waits) / run.frames if waits else None
