"""The port's tracer (``av1tpu_torch/utils/spans.py``) on a tiny chunked
stream on the CPU: a 64x64 key and two chunks of 2 P-frames through
``SpecTorchEngine``, once with the tracer off and once on.  Off records
nothing and on leaves the bytes alone; on, every chunk has its spans on
the threads that do its work, joined by its item, each child inside its
parent, on the clock of the benchmark's own spans."""

import threading

import pytest

from av1tpu_torch.config import TpuEncoderConfig
from av1tpu_torch.spec_engine import SpecTorchEngine
from av1tpu_torch.utils import spans
from av1tpu_torch.utils.cleansrc import clean_frame
from benchmark import trace

FRAMES = [clean_frame(64, 64, i) for i in range(5)]


def _stream(rec=None):
    eng = SpecTorchEngine(TpuEncoderConfig(chunk=2, golden=False, cdef=False,
                                           lr=False), device="cpu")
    patches = trace.Patches(eng)
    if rec is not None:
        patches.install("engine:_finalize_chunk", rec.around("finalize"))
        patches.install("av1tpu_torch.specav1.torch_intra:encode_frame",
                        rec.around("key"))
    try:
        return [bytes(p) for p, _ in eng.encode_stream(iter(FRAMES), 96)]
    finally:
        patches.restore()


@pytest.fixture(scope="module")
def runs():
    spans.disable()
    spans.drain()
    off = _stream()
    off_spans = spans.drain()
    rec = trace.Recorder()
    spans.enable()
    try:
        on = _stream(rec)
    finally:
        spans.disable()
    return {"off": off, "off_spans": off_spans, "on": on,
            "spans": spans.drain(), "rec": rec,
            "caller": threading.get_native_id()}


def _by(sp, name, item=None):
    return [s for s in sp if s.name == name and item in (None, s.item)]


def test_off_records_nothing_and_on_keeps_the_bytes(runs):
    assert runs["off_spans"] == []
    assert runs["on"] == runs["off"] and len(runs["on"]) == len(FRAMES)
    # off, a span is one shared no-op context and a stamp is 0
    assert spans.span("a") is spans.span("b", cpu=True)
    assert spans.begin() == 0 and spans.item() == 0
    spans.end("a", spans.begin())
    assert spans.drain() == []


def test_each_chunk_has_its_spans_joined_by_its_item(runs):
    sp, caller = runs["spans"], runs["caller"]
    chunks = [s.item for s in _by(sp, "issue")]
    assert len(chunks) == 2 and len(set(chunks)) == 2 and 0 not in chunks
    keys = _by(sp, "key")
    assert len(keys) == 1 and keys[0].item not in chunks
    assert keys[0].item < chunks[0] < chunks[1]  # sequence numbers
    for it in chunks:
        (queued,) = _by(sp, "dispatch.queued", it)
        (job,) = _by(sp, "dispatch.job", it)
        (issue,) = _by(sp, "issue", it)
        worker = job.tid
        assert worker != caller and queued.tid == issue.tid == worker
        assert job.n == issue.n == queued.n == 2
        (upload,) = _by(sp, "upload", it)
        assert len(_by(sp, "pack", it)) <= 1
        for child in [issue, upload] + _by(sp, "pack", it):
            assert child.parent == job.id and child.tid == worker
        for name in ("wait.dispatch", "wait.card", "wait.entropy"):
            (w,) = _by(sp, name, it)
            assert w.tid == caller
        ent = _by(sp, "entropy.queued", it)
        assert len(ent) == 2 and all(s.tid not in (caller, worker)
                                     for s in ent)


def test_children_inside_parents_and_cpu_within_wall(runs):
    sp = runs["spans"]
    ids = {s.id: s for s in sp}
    children = [s for s in sp if s.parent]
    assert {s.name for s in children} == {"pack", "upload", "issue",
                                          "key.wave"}
    for s in children:
        p = ids[s.parent]
        assert p.tid == s.tid and p.item == s.item
        assert p.t0 <= s.t0 <= s.t1 <= p.t1
    waves = _by(sp, "key.wave")
    assert waves and all(ids[s.parent].name == "key" for s in waves)
    for s in _by(sp, "issue"):
        assert 0 < s.cpu <= s.t1 - s.t0
    assert all(s.cpu is None for s in sp if s.name != "issue")


def test_program_spans_share_the_benchmark_clock(runs):
    """Each program span lies inside the benchmark's span of the call
    that holds it, on the same thread: the two share one clock."""
    sp, rec = runs["spans"], runs["rec"]

    def inside(s, outer):
        return any(r.tid == s.tid and r.t0 <= s.t0 / 1e9 and
                   s.t1 / 1e9 <= r.t1 for r in rec.spans if r.name == outer)
    chunks = {s.item for s in _by(sp, "issue")}
    waits = [s for s in sp if s.name.startswith("wait.")
             and s.item in chunks]
    assert len(waits) == 6 and all(inside(s, "finalize") for s in waits)
    assert all(inside(s, "key") for s in _by(sp, "key.wave"))
    assert not any(inside(s, "finalize") for s in _by(sp, "issue"))


def test_buffer_keeps_the_newest():
    spans.drain()
    spans.enable()
    try:
        for i in range(spans.CAPACITY + 10):
            spans.end("x", spans.begin(), item=i)
    finally:
        spans.disable()
    out = spans.drain()
    assert len(out) == spans.CAPACITY
    assert (out[0].item, out[-1].item) == (10, spans.CAPACITY + 9)
