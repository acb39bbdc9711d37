"""sample_mfu.sg2f1024: the window's model FLOPs (counted on the plain
StyleGAN2 reference on the ``meta`` device) at the card's peak of each one's
precision, over the window's time, in %."""

from gpu_bench import readers


def read(run):
    return readers.mfu(run)
