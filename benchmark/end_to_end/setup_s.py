"""setup_s: process start to the window's opening payload (imports, CUDA
context, the source frames, the kernel and tile-writer builds, and the
first frames of the cell's own kind)."""


def read(run):
    return run.setup_s
