"""train_loop.optimizer_ms: the device extents of a main iteration's
``train.adam`` spans (every ``ClippedAdam.step``: D's, cut-mix's, G's) and
its ``train.ema`` span, summed, in ms; mean over the traced cycle's main
iterations."""

from gpu_bench import spans


def read(run):
    return spans.per_main_iteration(run, ("train.adam", "train.ema"))
