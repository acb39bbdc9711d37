"""regularizers.path_length_span_ms: the device extent of the
``train.path_length`` span (the path-length update through the chunk ladder,
its G update and the EMA, f32), in ms; mean over the traced cycle."""

from gpu_bench import spans


def read(run):
    return spans.mean_extent(run, "train.path_length")
