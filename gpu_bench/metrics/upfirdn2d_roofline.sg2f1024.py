"""upfirdn2d_roofline.sg2f1024: the least time of the upfirdn2d kernels' launches over their
device time in the traced window of the StyleGAN2 sampling cell, in %."""

from gpu_bench import readers


def read(run):
    return readers.roofline(run, "upfirdn2d")
