"""pack_kept_share (upload): chunks uploaded packed over chunks on which
the pack was tried (``io_pack.pack_chunk`` returns None when it gives
up), in the window."""

SPANS = [{"target": "av1tpu_torch.encoder.io_pack:pack_chunk",
          "name": "pack"}]


def read(run):
    spans = run.spans("pack")
    return sum(not s.none for s in spans) / len(spans) if spans else None
