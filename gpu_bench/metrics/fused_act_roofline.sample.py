"""fused_act_roofline.sample: the least time of the fused_act kernels' launches over their
device time in the traced window, in %."""

from gpu_bench import readers


def read(run):
    return readers.roofline(run, "fused_act")
