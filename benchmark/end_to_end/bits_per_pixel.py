"""bits_per_pixel: the payload bits of the window's first frames (as many
as the traffic fixes) over their luma samples: the size gate's measure."""


def read(run):
    return run.bits_per_pixel
