"""The program's own spans (``av1tpu_torch.utils.spans``), as the per-layer
readers of ``layers/`` that list ``ON`` among their ``SPANS`` read them.

The program's tracer is off unless switched on.  The harness installs
the readers' ``SPANS`` in traced runs alone, and installing ``ON``
imports ``program_on``, which switches the tracer on for the rest of
the process: before ``encode_stream``, and never in an untraced run.  The
first reader takes the run's spans out of the tracer (``spans``) and
keeps them on the run as ``run.program``.  A program without the tracer
records none, and every reader of them returns None.

Program spans never enter ``Recorder.spans`` (``trace.Trace`` learns its
thread ids from the benchmark's own spans alone).  They share its clock,
``time.perf_counter``, in ns, so the marker alignment of the trace
places them on the trace's clock with ``trace.Trace``'s own arithmetic
(``placer``).
"""

from __future__ import annotations

ON = {"target": "benchmark.program_on:on", "name": "program_on"}
NS = 1e9


def _tracer():
    try:
        from av1tpu_torch.utils import spans as tracer
    except ImportError:  # a program without the tracer
        return None
    return tracer


def switch_on() -> None:
    tracer = _tracer()
    if tracer is not None:
        tracer.enable()


def spans(run):
    """The program's spans of the run, or None where it recorded none."""
    if getattr(run, "program", None) is None:
        tracer = _tracer()
        if tracer is None:
            return None
        run.program = tracer.drain()
    return run.program or None


def window(run, *names) -> list:
    """The program's spans named one of ``names`` that lie inside the
    window."""
    a, b = run.t_open * NS, run.t_close * NS
    return [s for s in spans(run) or () if s.name in names
            and s.t0 >= a and s.t1 <= b]


def ms(sp) -> float:
    return sum(s.t1 - s.t0 for s in sp) / 1e6


def merged(intervals) -> list:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(xs, ys) -> float:
    """The length of the intersection of two unions of intervals."""
    xs, ys = merged(xs), merged(ys)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        s, e = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, e - s)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def placer(run):
    """perf_counter ns -> the trace's clock in us: ``trace.Trace``'s
    ``place``, from the run's markers (``p_ref``, ``p_end``) and the
    trace's ``shift`` and ``drift``."""
    t, rec = run.trace, run.recorder
    ref, span_us = rec.p_ref * 1e6, (rec.p_end - rec.p_ref) * 1e6

    def place(ns):
        us = ns / 1e3
        frac = (us - ref) / span_us if span_us > 0 else 0.0
        return us + t.shift + t.drift * frac
    return place


def idle_in(run, name: str):
    """Of the device's idle time in the profiled sub-window
    (``Trace.gaps``), the share that the dispatch worker's ``name`` spans
    cover; None without a trace, kernels or the worker's spans."""
    t, sp = run.trace, spans(run)
    if t is None or not t.kernels or not sp:
        return None
    workers = {s.tid for s in sp if s.name == "dispatch.job"}
    if not workers:
        return None
    gaps = t.gaps()
    idle = sum(b - a for a, b in gaps)
    if not idle:
        return None
    place = placer(run)
    return overlap(gaps, [(place(s.t0), place(s.t1)) for s in sp
                          if s.name == name and s.tid in workers]) / idle
