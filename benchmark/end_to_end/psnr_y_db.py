"""psnr_y_db: luma PSNR of the window's first frames' reconstructions
against their sources, from the mean squared error of all their samples
(the benchmark's arithmetic): the quality floor."""


def read(run):
    return run.psnr_y_db
