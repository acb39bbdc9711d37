"""train_loop.d_step_ms: the device extent of the ``train.d_step`` span (the
D step with ADA and its D update), in ms; mean over the traced cycle's
main iterations."""

from gpu_bench import spans


def read(run):
    return spans.per_main_iteration(run, ("train.d_step",))
