"""submit_ms_per_frame (engine host): host time of the engine's submits
(``_submit`` for single frames, ``_submit_chunk`` on the caller's thread)
and of the launch issue of each chunk on the dispatch worker
(``spec_engine.encode_chunk``), over the window's frames."""

from benchmark import readers

SPANS = [{"target": "engine:_submit", "name": "submit"},
         {"target": "engine:_submit_chunk", "name": "submit_chunk"},
         readers.ENCODE_CHUNK]


def read(run):
    spans = [s for n in ("submit", "submit_chunk", "encode_chunk")
             for s in run.spans(n)]
    return readers.host_ms(spans) / run.frames if spans else None
