"""entropy_queue_ms_per_frame (entropy): the time the window's frames
waited in the entropy pool's queue, from the caller's ``map`` to the
start of each frame's coding (the program's ``entropy.queued`` spans),
over the window's frames."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    sp = program.window(run, "entropy.queued")
    return program.ms(sp) / run.frames if sp else None
