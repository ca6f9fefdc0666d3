"""k2_roofline (kernels, %): K2's share of its bound over the traced
launches: the sum of each launch's bound (the larger of its bytes over
the HBM rate and its operations over the int8 peak, from the frozen
count at the launch's own sizes) over the sum of the K2 kernels' device
time."""

from benchmark.frozen import roofline


def _info(blocks, regions, n, radius):
    return (int(blocks.shape[0]), int(n), int(radius))


SPANS = [{"target": "av1tpu_torch.encoder.kernels.refine:refine_ssd",
          "name": "k2", "info": _info}]


def read(run):
    if run.trace is None:
        return None
    infos = [s.info for s in sorted(run.recorder.spans, key=lambda s: s.t0)
             if s.name == "k2" and s.profiled]
    bound = dev = 0.0
    for i, k in run.trace.pair("k2", "refine_"):
        bound += roofline.bound_s(*roofline.k2_bytes_ops(*infos[i]))
        dev += (k[1] - k[0]) / 1e6
    return 100.0 * bound / dev if dev else None
