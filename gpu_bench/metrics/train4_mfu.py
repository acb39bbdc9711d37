"""train4_mfu: the window's model FLOPs of every rank at the peak of each
one's precision on as many cards, over rank 0's window, in %."""

from gpu_bench import readers


def read(run):
    share = readers.mfu(run)
    return None if share is None else share / run["readings"]["ranks"]
