"""train_loop.launches: the launch calls of kernels, copies and sets inside a
main iteration's ``train.step`` host span (runtime and driver API alike);
mean over the traced cycle's main iterations."""

from gpu_bench import spans


def read(run):
    return spans.per_main_count(run, spans.Window.launches)
