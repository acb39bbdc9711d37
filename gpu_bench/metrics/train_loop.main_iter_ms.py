"""train_loop.main_iter_ms: a main iteration (D step with ADA, cut-mix, G
step, EMA) on the host's clock, from its call until its metrics are read
to the host as the Trainer reads them; mean over the traced cycle's
iterations without R1 and path length."""

from gpu_bench import readers


def read(run):
    return readers.span_ms(run, "main_iter_s")
