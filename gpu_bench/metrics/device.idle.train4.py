"""device.idle.train4: the share of rank 0's traced window in which no
kernel, copy or set ran on its card, in %."""

from gpu_bench import readers


def read(run):
    return readers.idle(run)
