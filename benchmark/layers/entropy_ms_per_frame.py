"""entropy_ms_per_frame (entropy): host time of the native tile writer
(``specav1.native.encode_tile_rows``, on the engine's entropy pool for a
chunk's frames), summed over its threads, over the window's frames."""

from benchmark import readers

SPANS = [{"target": "av1tpu_torch.specav1.native:encode_tile_rows",
          "name": "entropy"}]


def read(run):
    spans = run.spans("entropy")
    return readers.host_ms(spans) / run.frames if spans else None
