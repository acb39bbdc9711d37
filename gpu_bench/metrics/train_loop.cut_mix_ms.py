"""train_loop.cut_mix_ms: the device extent of the ``train.cut_mix`` span (the
cut-mix step's two D updates), in ms; mean over the traced cycle's main
iterations that ran it."""

from gpu_bench import spans


def read(run):
    return spans.per_main_iteration(run, ("train.cut_mix",))
