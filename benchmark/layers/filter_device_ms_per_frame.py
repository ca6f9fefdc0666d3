"""filter_device_ms_per_frame (in-loop filters): device time of the
kernels launched inside the deblocking filter, the CDEF search and apply
and the LR search and apply, in the traced chunk dispatches that the
profiler held whole, over their frames."""

from benchmark import readers

SPANS = [readers.ENCODE_CHUNK,
         {"target": "av1tpu_torch.specav1.loopfilter:deblock_frame",
          "name": "deblock"},
         {"target": "av1tpu_torch.specav1.torch_cdef:cdef_search_apply",
          "name": "cdef"},
         {"target": "av1tpu_torch.specav1.torch_lr:lr_search_apply",
          "name": "lr"}]


def read(run):
    if run.trace is None:
        return None
    ks = readers.chunk_frames(run)
    if not sum(ks):
        return None
    us = 0.0
    for name in ("deblock", "cdef", "lr"):
        per = run.trace.kernels_by_range(name)
        for inner, f in zip(run.trace.ranges_within("encode_chunk", name), ks):
            if f:
                us += sum(e - s for i in inner for s, e, *_ in per[i])
    return us / 1e3 / sum(ks) if us else None
