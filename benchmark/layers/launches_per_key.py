"""launches_per_key (keyframe encoder): the ATen operations dispatched
on the device in a whole key, views left out (``OpCount``, a dispatch
mode of the benchmark's): one 1080p key is too many launches for the
profiler to hold."""


def read(run):
    n = sum(run.key_ops)
    return n / len(run.key_ops) if n else None
