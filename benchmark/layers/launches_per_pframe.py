"""launches_per_pframe (P-frame encoder): device kernels launched inside
the traced chunk dispatches (``spec_engine.encode_chunk``: the P-frame
encoder with its search and filters) that the profiler held whole, over
their frames."""

from benchmark import readers

SPANS = [readers.ENCODE_CHUNK]


def read(run):
    if run.trace is None:
        return None
    per = run.trace.kernels_by_range("encode_chunk")
    ks = readers.chunk_frames(run)
    n = sum(len(k) for k, f in zip(per, ks) if f)
    return n / sum(ks) if sum(ks) and n else None
