"""keyframe_fps: frames completed in the window over the window's length (host
clock; payloads of whole dispatches, entropy coding included)."""


def read(run):
    return run.rate
