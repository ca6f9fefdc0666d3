"""pack_ms_per_chunk (upload): host time of each ``io_pack.pack_chunk``
call in the window, those that give up included."""

from benchmark import readers

SPANS = [{"target": "av1tpu_torch.encoder.io_pack:pack_chunk",
          "name": "pack"}]


def read(run):
    spans = run.spans("pack")
    return readers.host_ms(spans) / len(spans) if spans else None
