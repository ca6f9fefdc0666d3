"""worker_idle_share (engine host): the share of the window during which
the dispatch worker ran no job (the program's ``dispatch.job`` spans,
cut to the window)."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    jobs = [(s.t0, s.t1) for s in program.spans(run) or ()
            if s.name == "dispatch.job"]
    if not jobs:
        return None
    a, b = run.t_open * program.NS, run.t_close * program.NS
    return 1.0 - program.overlap(jobs, [(a, b)]) / (b - a)
