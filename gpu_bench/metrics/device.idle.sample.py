"""device.idle.sample: the share of the traced window in which no kernel, copy or
set ran on the card, in %."""

from gpu_bench import readers


def read(run):
    return readers.idle(run)
