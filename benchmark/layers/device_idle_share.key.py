"""device_idle_share.key (device, keys): over the traced waves of a key's wavefront, one minus the union of the device's operations over the
sub-window's length (device trace)."""


def read(run):
    t = run.trace
    if t is None or t.t1 <= t.t0 or not t.kernels:
        return None
    return 1.0 - t.busy_us() / (t.t1 - t.t0)
