"""device.idle.train.main: the share of the union of the main iterations'
``train.step`` device extents in which no kernel, copy or set ran on the
card, in %."""

from gpu_bench import spans


def read(run):
    return spans.main_idle(run)
