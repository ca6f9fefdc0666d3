"""The reading of a device trace, on a hand-made one: spans placed by
the marker kernels, kernels attributed to the span that launched them,
K1-style pairing, the busy union, the idle gaps and their labels."""

import threading

import pytest

from benchmark import trace

TID = threading.get_native_id()


def _span(name, t0, t1):
    return trace.SpanRec(name, t0, t1, False, None, True)


def _events(lost=None):
    ev = []
    corr = iter(range(1, 100))

    def kernel(name, launch_us, start_us, dur_us, tid=TID):
        c = next(corr)
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch_us, "dur": 2, "tid": tid,
                   "args": {"correlation": c}})
        ev.append({"cat": "kernel", "name": name, "ts": start_us,
                   "dur": dur_us, "args": {"correlation": c}})
    # trace clock = perf_counter us + 1000; the window is [1000, 1100]
    kernel("gather_kernel<64>", 995, 996, 1)         # before the spans
    kernel(trace.MARKER, 1000, 1001, 0)
    kernel("gather_kernel<48>", 1010, 1012, 4)      # inside span k1 #0
    kernel("elementwise", 1015, 1016, 2)            # inside encode_chunk
    kernel("gather_kernel<32>", 1030, 1031, 3)      # inside span k1 #1
    kernel("copy", 1050, 1060, 10)                  # inside capture
    kernel(trace.MARKER, 1100, 1100, 0)
    if lost is not None:  # one marker's kernel missing from the trace
        i = [k for k, e in enumerate(ev) if e["name"] == trace.MARKER]
        del ev[i[0 if lost == "start" else -1]]
    return ev


def _trace(lost=None):
    spans = [_span("encode_chunk", 5e-6, 60e-6), _span("k1", 8e-6, 12e-6),
             _span("k1", 28e-6, 33e-6), _span("capture", 48e-6, 52e-6)]
    return trace.Trace(_events(lost), spans, p_ref=0.0, p_end=100e-6)


@pytest.mark.parametrize("lost", [None, "start", "end"])
def test_spans_placed_by_the_markers(lost):
    t = _trace(lost)
    assert (t.t0, t.t1) == (1000, 1100) and t.drift == 0
    assert t.marks == ((lost != "start") * 1, (lost != "end") * 1)
    assert t.ranges["k1"][0][1:] == pytest.approx((1008, 1012))


def test_kernels_by_range_and_capture_left_out():
    t = _trace()
    names = [[k[2] for k in ks] for ks in t.kernels_by_range("encode_chunk")]
    assert names == [["gather_kernel<48>", "elementwise",
                      "gather_kernel<32>"]]
    assert all(k[2] != "copy" for k in t.kernels)


@pytest.mark.parametrize("lost", [None, "start"])
def test_pair_in_launch_order(lost):
    t = _trace(lost)
    pairs = t.pair("k1", "gather_kernel")
    assert [(i, k[2]) for i, k in pairs] == [(0, "gather_kernel<48>"),
                                            (1, "gather_kernel<32>")]


def test_busy_gaps_and_labels():
    t = _trace()
    # device busy: [1012,1016] + [1016,1018] + [1031,1034] + [1060,1070]
    # (the kernel at 996 ran before the window)
    assert t.busy_us() == pytest.approx(4 + 2 + 3 + 10)
    gaps = t.gaps()
    assert gaps[0] == pytest.approx((1000, 1012))
    assert sum(b - a for a, b in gaps) == pytest.approx(100 - 19)
    b = t.breakdown()
    assert b["device_ops"][0] == ["copy", pytest.approx(10e-6)]
    # the longest gap falls after every span, the next inside encode_chunk
    assert b["idle_gaps"][0] == ["none", pytest.approx(30e-6)]
    assert b["idle_gaps"][1] == ["encode_chunk", pytest.approx(26e-6)]


def test_thread_ids_learned_from_the_launches():
    # the trace names two threads by ids the spans do not know: 888 runs
    # only inside the worker's span, 999 inside both the worker's span and
    # the entropy thread's shorter one
    spans = [_span("encode_chunk", 5e-6, 90e-6), _span("finalize", 20e-6,
                                                       30e-6)]
    spans[0].tid, spans[0].ident = 11, 11
    spans[1].tid, spans[1].ident = 22, 22
    ev = []
    for c, (name, tid, launch_us) in enumerate([
            (trace.MARKER, TID, 1000), ("k1", 888, 1010), ("k2", 888, 1040),
            ("k3", 999, 1022), ("k4", 999, 1025), (trace.MARKER, TID, 1100)]):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch_us, "dur": 1, "tid": tid,
                   "args": {"correlation": c}})
        ev.append({"cat": "kernel", "name": name, "ts": launch_us + 1,
                   "dur": 1, "args": {"correlation": c}})
    t = trace.Trace(ev, spans, p_ref=0.0, p_end=100e-6)
    assert t.thread_ids["888"] == [2, "learned"]
    # both threads' spans hold 999's launches: placed by time, so they
    # count in each range that is open at their launch
    assert t.thread_ids["999"] == [2, "time"]
    assert t.shares["999"] == [1.0, 1.0]
    assert [[k[2] for k in ks] for ks in t.kernels_by_range("finalize")] \
        == [["k3", "k4"]]
    assert [[k[2] for k in ks] for ks in
            t.kernels_by_range("encode_chunk")] == [["k1", "k3", "k4", "k2"]]
