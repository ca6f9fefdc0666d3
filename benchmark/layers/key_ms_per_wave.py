"""key_ms_per_wave (keyframe encoder): the host time of each wave of
set-up's first key, the keyframe wavefront's steps (the program's
``key.wave`` spans inside the first ``key`` span), over its waves."""

from benchmark import program

SPANS = [program.ON]


def read(run):
    sp = program.spans(run) or ()
    keys = [s for s in sp if s.name == "key"
            and s.t1 <= run.t_open * program.NS]
    if not keys:
        return None
    first = min(keys, key=lambda s: s.t0).id
    waves = [s for s in sp if s.name == "key.wave" and s.parent == first]
    return program.ms(waves) / len(waves) if waves else None
