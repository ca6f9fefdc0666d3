"""The readers of the program's own spans (``program.py``), on a
hand-made device trace and hand-made program spans: each returns the
value worked out by hand, and None without spans; the benchmark's own
spans, and so the readers of them, are the same with program spans
present; ``program.ON`` switches the program's tracer on, and a program
without the tracer leaves every reader None."""

import sys
import threading

import pytest

from av1tpu_torch.utils import spans as tracer
from benchmark import harness, program, trace

TID = threading.get_native_id()
WORKER, CALLER, POOL = 11, 22, 33
CELL = "spec1080-last.grain-p"
NEW = {"dispatch_queue_ms_per_chunk", "worker_idle_share",
       "caller_wait_ms_per_frame", "issue_cpu_share",
       "entropy_queue_ms_per_frame", "upload_ms_per_chunk",
       "idle_in_pack_share", "idle_worker_waiting_share", "key_ms_per_wave"}


def _events():
    """Trace clock = perf_counter us + 1000; the profiled sub-window is
    [1000, 1100]; the device runs [1010, 1020] and [1050, 1060], so it
    idles over [1000, 1010], [1020, 1050], [1060, 1100]: 80 us."""
    ev = []
    for c, (name, launch, start, dur) in enumerate([
            (trace.MARKER, 1000, 1001, 0), ("k_a", 1009, 1010, 10),
            ("k_b", 1049, 1050, 10), (trace.MARKER, 1100, 1100, 0)]):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "tid": TID,
                   "args": {"correlation": c}})
        ev.append({"cat": "kernel", "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": c}})
    return ev


def _program():
    """A key (item 1) and a later one in set-up, two chunks of 2 frames
    (items 2, 3) in the window [0, 100000] and a third after it; times
    in perf_counter ns."""
    sp = []

    def add(name, t0, t1, tid, item, n=1, parent=0, cpu=None):
        sp.append(tracer.Span(name, t0, t1, tid, len(sp) + 1, parent, item,
                              n, cpu))
        return len(sp)
    key = add("key", -50_000, -10_000, CALLER, 1)
    add("key.wave", -45_000, -35_000, CALLER, 1, 0, key)
    add("key.wave", -30_000, -15_000, CALLER, 1, 0, key)
    later = add("key", -9_000, -1_000, CALLER, 9)
    add("key.wave", -8_000, -3_000, CALLER, 9, 0, later)

    add("dispatch.queued", 2_000, 5_000, WORKER, 2, 2)
    job = add("dispatch.job", 5_000, 45_000, WORKER, 2, 2)
    add("pack", 8_000, 25_000, WORKER, 2, 2, job)
    add("upload", 25_000, 26_000, WORKER, 2, 2, job)
    add("issue", 26_000, 45_000, WORKER, 2, 2, job, cpu=9_500)
    add("wait.dispatch", 46_000, 50_000, CALLER, 2, 2)
    add("wait.card", 50_000, 51_000, CALLER, 2, 2)
    add("wait.entropy", 52_000, 60_000, CALLER, 2, 2)
    add("entropy.queued", 52_000, 53_000, POOL, 2)
    add("entropy.queued", 52_000, 55_000, POOL + 1, 2)

    add("dispatch.queued", 30_000, 70_000, WORKER, 3, 2)
    job = add("dispatch.job", 70_000, 90_000, WORKER, 3, 2)
    add("pack", 70_000, 80_000, WORKER, 3, 2, job)
    add("upload", 80_000, 81_000, WORKER, 3, 2, job)
    add("issue", 81_000, 90_000, WORKER, 3, 2, job, cpu=4_500)
    add("wait.dispatch", 91_000, 92_000, CALLER, 3, 2)
    add("wait.card", 92_000, 93_000, CALLER, 3, 2)
    add("wait.entropy", 93_000, 99_000, CALLER, 3, 2)
    add("entropy.queued", 93_000, 94_000, POOL, 3)
    add("entropy.queued", 93_000, 96_000, POOL + 1, 3)

    add("dispatch.queued", 95_000, 120_000, WORKER, 4, 2)
    job = add("dispatch.job", 120_000, 130_000, WORKER, 4, 2)
    add("issue", 121_000, 130_000, WORKER, 4, 2, job, cpu=9_000)
    return sp


# by hand: queued (3 + 40) / 2 us; the worker's jobs cover 60 of the 100
# us window; the caller waits 4 + 1 + 8 + 1 + 1 + 6 = 21 us over 4
# frames; issue CPU 14 of 28 us; entropy queues 8 us over 4 frames;
# uploads 1 us a chunk; idle 80 us, of which packs [1008, 1025] and
# [1070, 1080] cover 2 + 5 + 10, jobs [1005, 1045] and [1070, 1090] 5 +
# 25 + 20; the first key's two waves 10 + 15 us
WANT = {"dispatch_queue_ms_per_chunk": 0.0215, "worker_idle_share": 0.4,
        "caller_wait_ms_per_frame": 0.00525, "issue_cpu_share": 0.5,
        "entropy_queue_ms_per_frame": 0.002, "upload_ms_per_chunk": 0.001,
        "idle_in_pack_share": 17 / 80, "idle_worker_waiting_share": 30 / 80,
        "key_ms_per_wave": 0.0125}


def _run(**kw):
    rec = trace.Recorder()
    rec.p_ref, rec.p_end = 0.0, 100e-6
    rec.spans.append(trace.SpanRec("encode_chunk", 5e-6, 45e-6, False, 2,
                                   True))
    t = trace.Trace(_events(), rec.spans, rec.p_ref, rec.p_end)
    return harness.Run(frames=4, t_open=0.0, t_close=100e-6, recorder=rec,
                       trace=t, key_ops=[], **kw)


def _readers():
    return {m["name"]: mod for m, mod in harness.load_cell(CELL)["per_layer"]}


def test_each_reader_reads_the_hand_worked_value():
    readers = _readers()
    assert NEW <= set(readers)
    run = _run(program=_program())
    got = {n: readers[n].read(run) for n in NEW}
    assert got == {n: pytest.approx(v) for n, v in WANT.items()}
    assert got["idle_in_pack_share"] + got["idle_worker_waiting_share"] <= 1
    assert all(program.ON in readers[n].SPANS for n in NEW)


def test_none_without_program_spans():
    readers = _readers()
    tracer.drain()
    for run in (_run(program=[]), _run()):
        assert {n: readers[n].read(run) for n in NEW} == dict.fromkeys(NEW)


def test_benchmark_spans_and_their_readers_unchanged():
    readers = _readers()
    old = set(readers) - NEW
    bare, withp = _run(program=[]), _run(program=_program())
    before = list(withp.recorder.spans)
    for n in NEW:
        readers[n].read(withp)
    assert withp.recorder.spans == before
    assert {n: readers[n].read(bare) for n in old} == \
        {n: readers[n].read(withp) for n in old}
    assert readers["device_idle_share"].read(withp) == pytest.approx(0.8)


@pytest.fixture
def fresh_switch():
    sys.modules.pop("benchmark.program_on", None)
    tracer.disable()
    tracer.drain()
    yield
    sys.modules.pop("benchmark.program_on", None)
    tracer.disable()
    tracer.drain()


def test_installing_on_switches_the_tracer_on(fresh_switch):
    patches = trace.Patches(None)
    patches.install(program.ON["target"],
                    trace.Recorder().around(program.ON["name"]))
    patches.restore()
    assert tracer.begin() != 0  # on


def test_a_program_without_the_tracer_reads_none(fresh_switch, monkeypatch):
    import av1tpu_torch.utils
    monkeypatch.delattr(av1tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "av1tpu_torch.utils.spans", None)
    program.switch_on()
    assert tracer.begin() == 0  # off
    run = _run()
    assert program.spans(run) is None and program.window(run, "issue") == []
    readers = _readers()
    assert all(readers[n].read(run) is None for n in NEW)
