"""k1_roofline (kernels, %): K1's share of its bound over the traced
launches: the sum of each launch's bound (the bytes its windows need,
from the frozen count applied to the launch's own arguments, over the
HBM rate) over the sum of the K1 kernels' device time."""

from benchmark.frozen import roofline


def _one(planes, oy, ox, W):
    p = planes if not isinstance(planes, (tuple, list)) else planes[0]
    n = 1 if not isinstance(planes, (tuple, list)) else len(planes)
    return (tuple(p.shape), p.element_size(), n, None, oy, ox, W)


def _two(p0, p1, ri, oy, ox, W):
    p = p0 if not isinstance(p0, (tuple, list)) else p0[0]
    n = 1 if not isinstance(p0, (tuple, list)) else len(p0)
    return (tuple(p.shape), p.element_size(), n, ri, oy, ox, W)


SPANS = [{"target": "av1tpu_torch.encoder.kernels.gather:gather_windows",
          "name": "k1", "info": _one},
         {"target": "av1tpu_torch.encoder.kernels.gather:gather_windows2",
          "name": "k1", "info": _two}]


def read(run):
    if run.trace is None:
        return None
    infos = [s.info for s in sorted(run.recorder.spans, key=lambda s: s.t0)
             if s.name == "k1" and s.profiled]
    bound = dev = 0.0
    for i, k in run.trace.pair("k1", "gather_kernel"):
        bound += roofline.bound_s(roofline.touched_bytes(*infos[i]))
        dev += (k[1] - k[0]) / 1e6
    return 100.0 * bound / dev if dev else None
