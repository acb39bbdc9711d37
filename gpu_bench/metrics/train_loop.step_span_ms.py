"""train_loop.step_span_ms: the device extent of the program's ``train.step``
span (``Trainer._run_step``), from the first start to the last end of the
work launched inside it, in ms; mean over the traced cycle's main
iterations (the in-program counterpart of ``train_loop.main_iter_ms``)."""

from gpu_bench import spans


def read(run):
    return spans.per_main_iteration(run, ("train.step",))
