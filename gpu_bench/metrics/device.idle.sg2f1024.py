"""device.idle.sg2f1024: the share of the StyleGAN2 sampling cell's traced
window in which no kernel, copy or set ran on the card, in %."""

from gpu_bench import readers


def read(run):
    return readers.idle(run)
