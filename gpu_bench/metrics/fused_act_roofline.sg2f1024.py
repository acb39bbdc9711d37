"""fused_act_roofline.sg2f1024: the least time of the fused_act kernels' launches over their
device time in the traced window of the StyleGAN2 sampling cell, in %."""

from gpu_bench import readers


def read(run):
    return readers.roofline(run, "fused_act")
