"""train_loop.g_step_ms: the device extent of the ``train.g_step`` span (the G
step with top-k and its G update), in ms; mean over the traced cycle's
main iterations."""

from gpu_bench import spans


def read(run):
    return spans.per_main_iteration(run, ("train.g_step",))
