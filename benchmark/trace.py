"""Spans, counts and the device trace that the per-layer metrics read.

Everything is recorded from the benchmark's side of the calls into the
program: a wrapper (``Spy``) in place of a module function or an engine
method records each call's host span (thread, start, end on
``time.perf_counter``).  The profiler's chrome trace gives the device's
operations and, for each kernel, the host thread and time of its launch;
the spans are placed on the trace's clock by a marker kernel launched at
a known time as the profiler starts, and a kernel belongs to the span
whose interval on its thread holds its launch.  A thread's id in the
trace is matched to the spans' thread by its native or pthread id, or
else learned from the launches (``_learn_threads``); a launch of a
thread still unmatched is placed by time alone.  Nothing is added
inside the program.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import threading
import time


class Spy:
    """A callable in place of a function or a bound method: calls
    ``around(fn, args, kwargs)``, and forwards every other attribute read
    and write to it (the kernel wrappers' launch counters are attributes
    of the function, incremented through its module name)."""

    def __init__(self, fn, around):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_around", around)

    def __call__(self, *a, **k):
        return self._around(self._fn, a, k)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_fn"), name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


class Patches:
    """Spies installed on ``module:attr`` targets or on ``engine:method``
    (an attribute of the engine instance), removed by ``restore``."""

    def __init__(self, engine):
        self.engine = engine
        self._undo = []

    def install(self, target: str, around) -> None:
        owner_name, attr = target.split(":")
        if owner_name == "engine":
            owner = self.engine
            prev = owner.__dict__.get(attr)
            self._undo.append(lambda: setattr(owner, attr, prev)
                              if prev is not None else delattr(owner, attr))
            setattr(owner, attr, Spy(getattr(owner, attr), around))
            return
        owner = importlib.import_module(owner_name)
        real = getattr(owner, attr)
        self._undo.append(lambda: setattr(owner, attr, real))
        setattr(owner, attr, Spy(real, around))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()


class SpanRec:
    __slots__ = ("name", "tid", "ident", "t0", "t1", "none", "info",
                 "profiled", "whole")

    def __init__(self, name, t0, t1, none, info, profiled, whole=None):
        self.name, self.t0, self.t1 = name, t0, t1
        # a trace names a thread by its native id or, for a thread that
        # ran no profiled operation, by its pthread id
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()
        self.none, self.info, self.profiled = none, info, profiled
        # begun and ended while the profiler ran: every launch in the trace
        self.whole = profiled if whole is None else whole


class Recorder:
    """Host spans of the calls the cell's per-layer metrics name, and the
    profiler's state (``profiling``; ``p_ref``, ``p_end``: ``perf_counter``
    at its two markers)."""

    def __init__(self):
        self.spans: list = []
        self.profiling = False
        self.p_ref = self.p_end = 0.0
        self.start_s = 0.0  # host seconds the profiler took to start

    def add(self, name, t0, t1, none=False, info=None, profiled=None,
            whole=None):
        self.spans.append(SpanRec(
            name, t0, t1, none, info,
            self.profiling if profiled is None else profiled, whole))

    def around(self, name: str, info=None):
        """The ``around`` function of a span named ``name``; ``info``,
        given the call's arguments, keeps what a reader needs of them
        (taken only while the profiler runs)."""
        def call(fn, a, k):
            prof = self.profiling
            inf = info(*a, **k) if (info is not None and prof) else None
            t0 = time.perf_counter()
            res = fn(*a, **k)
            # profiled: begun inside the profiled sub-window
            self.add(name, t0, time.perf_counter(), res is None, inf, prof,
                     prof and self.profiling)
            return res
        return call

    def count(self, name: str) -> int:
        """The spans of ``name`` recorded so far that the profiler held
        whole."""
        return sum(1 for s in list(self.spans)
                   if s.name == name and s.whole)

    def window(self, name: str, t_open: float, t_close: float) -> list:
        """The spans of ``name`` that lie inside the window."""
        return [s for s in self.spans
                if s.name == name and s.t0 >= t_open and s.t1 <= t_close]


@contextlib.contextmanager
def profiled(rec: Recorder, on_cuda: bool):
    """torch.profiler over the block, tracing the device alone (the host's
    operations are not recorded: that would slow the host several times
    over and inflate the device's idle share).  A marker kernel at each
    end (``torch.cuda._sleep``), launched at a known ``perf_counter``
    (``p_ref``, ``p_end``), places the spans on the trace's clock."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA if on_cuda
                               else ProfilerActivity.CPU])
    t = time.perf_counter()
    prof.start()
    rec.start_s = time.perf_counter() - t

    def mark():
        t = time.perf_counter()
        if on_cuda:
            import torch
            torch.cuda._sleep(1)
        return t
    try:
        rec.p_ref = mark()
        rec.profiling = True
        yield prof
        rec.profiling = False
        rec.p_end = mark()
        if on_cuda:
            import torch
            torch.cuda.synchronize()
    finally:
        rec.profiling = False
        prof.stop()


# device activity kinds of a chrome trace that count as device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the marker kernel of ``profiled`` (``torch.cuda._sleep``)
MARKER = "spin_kernel"


class Trace:
    """A profiled sub-window: the device's operations and their launches
    from the profiler's chrome trace, and the spans recorded while it ran
    (``ranges``: span name -> [(tid, start, end)] in start order), all in
    microseconds on the trace's clock."""

    def __init__(self, events: list, spans=(), p_ref=0.0, p_end=0.0):
        self.ops = []        # (ts, end, name, cat, correlation)
        launch = {}          # correlation -> (tid, ts) of the host launch
        for e in events:
            cat = e.get("cat")
            args = e.get("args") or {}
            if cat in _DEVICE_CATS:
                ts = float(e["ts"])
                self.ops.append((ts, ts + float(e.get("dur", 0)), e["name"],
                                 cat, args.get("correlation")))
            elif cat == "cuda_runtime":
                launch[args.get("correlation")] = (e.get("tid"),
                                                   float(e["ts"]))
        # the markers' launches; each is the start marker or the end one
        # by the share of all launches before it, so that either alone
        # still places the spans (a second profiler session of a process
        # on the H100 has been seen to leave the marker kernels out)
        marks = sorted(launch[o[4]][1] for o in self.ops
                       if MARKER in o[2] and o[4] in launch)
        every = sorted(ts for _, ts in launch.values())
        late = [bisect.bisect_left(every, m) > len(every) // 2
                for m in marks]
        starts = [m for m, e in zip(marks, late) if not e]
        ends = [m for m, e in zip(marks, late) if e]
        self.marks = (len(starts), len(ends))
        self.ops = sorted(o for o in self.ops if MARKER not in o[2])
        # trace clock = perf_counter microseconds + shift (+ drift, spread
        # over the sub-window)
        self.shift = (starts[0] - p_ref * 1e6 if starts
                      else ends[-1] - p_end * 1e6 if ends else 0.0)
        self.drift = (ends[-1] - p_end * 1e6 - self.shift
                      if starts and ends else 0.0)
        self.t0 = p_ref * 1e6 + self.shift
        self.t1 = p_end * 1e6 + self.shift
        span_us = (p_end - p_ref) * 1e6

        def place(t):  # perf_counter seconds -> trace clock
            us = t * 1e6
            frac = (us - p_ref * 1e6) / span_us if span_us > 0 else 0.0
            return us + self.shift + self.drift * frac
        self.ranges = {}
        alias = {}           # a thread's ids in the trace -> native id
        for s in spans:
            if s.profiled:
                self.ranges.setdefault(s.name, []).append(
                    (s.tid, place(s.t0), place(s.t1)))
                low = s.ident & 0xFFFFFFFF
                for a in (s.tid, s.ident, low, low - (1 << 32) * (
                        low >> 31)):
                    alias[a] = alias[str(a)] = s.tid
        for v in self.ranges.values():
            v.sort(key=lambda r: r[1])
        learned = self._learn_threads(launch, alias)
        counts = {}
        for t, _ in launch.values():
            counts[t] = counts.get(t, 0) + 1
        # each thread id of the trace: its launches, and how it was matched
        self.thread_ids = {str(t): [n, "span" if t in alias else
                                    "learned" if t in learned else "time"]
                           for t, n in counts.items()}
        alias.update(learned)
        # launches of a thread the spans do not name are placed by time
        self.launch = {c: (alias.get(t), ts) for c, (t, ts) in launch.items()}
        self.by_thread = sum(t is not None for t, _ in self.launch.values())
        self.kernels = [o for o in self.ops if o[3] == "kernel"]
        # kernels the benchmark itself launched (its recon copies)
        own = self._inside("capture")
        self.kernels = [o for o in self.kernels if id(o) not in own]

    def _learn_threads(self, launch: dict, alias: dict) -> dict:
        """Trace thread id -> the spans' thread, for the ids that name no
        span thread: the one thread whose spans hold 95% or more of the
        id's launches, where no other thread's hold half of them.  Where
        two threads' spans hold them (a thread that waits all through the
        window holds every launch by time alone), the id stays unmatched
        and its launches are placed by time."""
        merged = {}
        for rs in self.ranges.values():
            for tid, s, e in rs:
                merged.setdefault(tid, []).append((s, e))
        for tid, iv in merged.items():
            iv.sort()
            out = [list(iv[0])]
            for s, e in iv[1:]:
                if s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            merged[tid] = ([a for a, _ in out], [b for _, b in out])
        by_id = {}
        for t, ts in launch.values():
            if t not in alias:
                by_id.setdefault(t, []).append(ts)
        learned, self.shares = {}, {}
        for t, tss in by_id.items():
            share = {}
            for tid, (starts, ends) in merged.items():
                held = 0
                for ts in tss:
                    j = bisect.bisect_right(starts, ts) - 1
                    held += j >= 0 and ts <= ends[j]
                share[tid] = held / len(tss)
            # the two largest shares, for the log
            self.shares[str(t)] = sorted(
                (round(f, 4) for f in share.values()), reverse=True)[:2]
            best = [tid for tid, f in share.items() if f >= 0.95]
            if len(best) == 1 and sum(f >= 0.5 for f in share.values()) == 1:
                learned[t] = best[0]
        return learned

    @classmethod
    def from_profiler(cls, prof, path: str, rec: Recorder) -> "Trace":
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        return cls(events, rec.spans, rec.p_ref, rec.p_end)

    def pair(self, name: str, pattern: str) -> list:
        """The ``name`` spans, each with the one kernel named ``pattern``
        that it launched, in order: one thread issues them onto one
        stream, so the device runs them in launch order, and those
        launched before the sub-window (or before the profiler, with no
        launch in the trace) come first.  [] where the trace holds
        fewer."""
        n = len(self.ranges.get(name, []))
        ks = sorted(k for k in self.kernels if pattern in k[2])
        a = sum(1 for k in ks
                if self.launch.get(k[4], (None, self.t0 - 1))[1] < self.t0)
        return list(enumerate(ks[a:a + n])) if len(ks) - a >= n else []

    def _inside(self, name: str) -> dict:
        """id(op) -> index of the ``name`` range whose interval on the
        launching thread holds the op's launch (on any thread, for a
        launch whose thread is unmatched)."""
        by_tid = {}
        for i, (tid, ts, end) in enumerate(self.ranges.get(name, [])):
            by_tid.setdefault(tid, []).append((ts, end, i))
            by_tid.setdefault(None, []).append((ts, end, i))
        starts = {t: [r[0] for r in v] for t, v in by_tid.items()}
        out = {}
        for o in self.ops:
            ln = self.launch.get(o[4])
            if ln is None:
                continue
            key = ln[0]
            v = by_tid.get(key)
            if not v:
                continue
            j = bisect.bisect_right(starts[key], ln[1]) - 1
            if j >= 0 and v[j][0] <= ln[1] <= v[j][1]:
                out[id(o)] = v[j][2]
        return out

    def kernels_by_range(self, name: str) -> list:
        """For each ``name`` range, in order, the kernels it launched."""
        inside = self._inside(name)
        out = [[] for _ in self.ranges.get(name, [])]
        for k in self.kernels:
            i = inside.get(id(k))
            if i is not None:
                out[i].append(k)
        return out

    def ranges_within(self, outer: str, inner: str) -> list:
        """For each ``outer`` range, the indices of the ``inner`` ranges
        on its thread that lie inside it."""
        inn = self.ranges.get(inner, [])
        return [[i for i, (t2, s2, e2) in enumerate(inn)
                 if t2 == tid and s2 >= s and e2 <= e]
                for tid, s, e in self.ranges.get(outer, [])]

    def busy_us(self) -> float:
        """The union of the device operations' intervals in the window."""
        busy, cur_s, cur_e = 0.0, None, None
        for s, e, *_ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def gaps(self) -> list:
        """The device's idle intervals in the window, (start, end)."""
        out, t = [], self.t0
        for s, e, *_ in self.ops:
            if s > t:
                out.append((t, min(s, self.t1)))
            t = max(t, e)
            if t >= self.t1:
                break
        if t < self.t1:
            out.append((t, self.t1))
        return [g for g in out if g[1] > g[0]]

    def host_label(self, t: float) -> str:
        """The spans open at time t, on any thread."""
        names = sorted({n for n, rs in self.ranges.items()
                        if any(s <= t <= e for _, s, e in rs)})
        return "+".join(names) or "none"

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps by what the host was doing, in seconds."""
        by_name = {}
        for s, e, name, *_ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:120], v / 1e6] for n, v in top],
                "idle_gaps": [[self.host_label((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}
