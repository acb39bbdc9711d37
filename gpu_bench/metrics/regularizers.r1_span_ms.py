"""regularizers.r1_span_ms: the device extent of the ``train.r1`` span (R1's
penalty and its D update, f32), in ms, with no synchronise around it; mean
over the traced cycle."""

from gpu_bench import spans


def read(run):
    return spans.mean_extent(run, "train.r1")
