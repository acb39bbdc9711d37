"""upfirdn2d_roofline.sample: the least time of the upfirdn2d kernels' launches over their
device time in the traced window, in %."""

from gpu_bench import readers


def read(run):
    return readers.roofline(run, "upfirdn2d")
