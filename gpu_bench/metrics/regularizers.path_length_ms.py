"""regularizers.path_length_ms: the path-length update through the port's
chunk ladder (``Trainer.path_length``), the card synchronised at both ends
(traced run only); mean over the traced cycle."""

from gpu_bench import readers


def read(run):
    return readers.span_ms(run, "path_length_s")
