"""train_mfu: the window's model FLOPs at the card's peak of each one's precision,
over the window's time, in %."""

from gpu_bench import readers


def read(run):
    return readers.mfu(run)
