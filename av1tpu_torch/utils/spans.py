"""The port's own tracer: spans recorded where the engine's work happens.

Off by default.  Off, ``span`` returns one shared no-op context,
``begin`` and ``item`` return 0 and ``end`` of a 0 stamp records
nothing: one flag test and no allocation a span.  On (``enable``), each
span is a ``Span`` appended to a bounded in-memory buffer (the newest
``CAPACITY``; the oldest are dropped), taken out by ``drain``.

Times are ``time.perf_counter_ns``, the clock of ``time.perf_counter``,
so a span lies on the same clock as any span a caller takes around a
call into the engine.  A span opened with ``span`` is the parent of the
spans opened inside it on the same thread (a thread-local stack), and
gives them its ``item`` and ``n`` unless they name their own.  ``item``
is the dispatch's sequence number (``item()``, taken at submit): every
span of one chunk or frame carries it, on every thread.

    with spans.span("issue", item=seq, n=k, cpu=True):
        ...
    t = spans.begin()            # stamped on one thread
    spans.end("queued", t, item=seq, n=k)  # recorded on another
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

CAPACITY = 65_536

_on = False
_buf: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_items = itertools.count(1)
_local = threading.local()
_NOOP = contextlib.nullcontext()


class Span:
    """One span: ``name``; ``t0``, ``t1`` (``time.perf_counter_ns``);
    ``tid`` (``threading.get_native_id`` of the thread that ran it);
    ``id``; ``parent`` (the id of the innermost span open on that thread
    when it began, 0 for none); ``item`` (the dispatch's sequence number,
    0 for none); ``n`` (the frames it covers); ``cpu`` (the thread's CPU
    time over it in ns, ``time.thread_time_ns``, where asked for, else
    None)."""

    __slots__ = ("name", "t0", "t1", "tid", "id", "parent", "item", "n",
                 "cpu")

    def __init__(self, name: str, t0: int = 0, t1: int = 0, tid: int = 0,
                 id: int = 0, parent: int = 0, item: int = 0, n: int = 1,
                 cpu=None):
        self.name, self.t0, self.t1, self.tid = name, t0, t1, tid
        self.id, self.parent, self.item, self.n = id, parent, item, n
        self.cpu = cpu

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.item is None:
                self.item = top.item
            if self.n is None:
                self.n = top.n
        self.item = self.item or 0
        self.n = 1 if self.n is None else self.n
        self.id = next(_ids)
        self.tid = threading.get_native_id()
        stack.append(self)
        # the wall interval holds the CPU one
        self.t0 = time.perf_counter_ns()
        if self.cpu is not None:
            self.cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        if self.cpu is not None:
            self.cpu = time.thread_time_ns() - self.cpu
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        _buf.append(self)
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> list:
    """The spans recorded since the last drain, oldest first; empties the
    buffer."""
    out = []
    while True:
        try:
            out.append(_buf.popleft())
        except IndexError:
            return out


def item() -> int:
    """A new dispatch sequence number (from 1), or 0 while off."""
    return next(_items) if _on else 0


def span(name: str, item=None, n=None, cpu: bool = False):
    """A context that records a span of the block; ``item`` and ``n``
    default to the enclosing span's; ``cpu`` also takes the thread's CPU
    time over it."""
    if not _on:
        return _NOOP
    return Span(name, item=item, n=n, cpu=0 if cpu else None)


def begin() -> int:
    """A start stamp for ``end``, or 0 while off."""
    return time.perf_counter_ns() if _on else 0


def end(name: str, t0: int, item: int = 0, n: int = 1) -> None:
    """Records a span from stamp ``t0`` (taken by ``begin``, on any
    thread) to now, on this thread; nothing for a 0 stamp."""
    if not t0:
        return
    stack = _stack()
    _buf.append(Span(name, t0, time.perf_counter_ns(),
                     threading.get_native_id(), next(_ids),
                     stack[-1].id if stack else 0, item, n))
