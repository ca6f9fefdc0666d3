"""Span targets and helpers shared by the per-layer readers (`layers/`)."""

ENCODE_CHUNK = {"target": "av1tpu_torch.spec_engine:encode_chunk",
                "name": "encode_chunk",
                "info": lambda *a, **k: int(k["k"])}


def host_ms(spans) -> float:
    return sum(s.t1 - s.t0 for s in spans) * 1e3


def chunk_frames(run) -> list:
    """Frames of each traced encode_chunk range, in order (the spans that
    started while the profiler ran, as many as the trace holds); 0 for
    one that ran on past the profiler's end, so that not all of its
    launches are in the trace."""
    ks = [s.info if s.whole else 0
          for s in sorted(run.recorder.spans, key=lambda s: s.t0)
          if s.name == "encode_chunk" and s.profiled]
    return ks[:len(run.trace.ranges.get("encode_chunk", []))]
