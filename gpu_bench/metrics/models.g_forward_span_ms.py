"""models.g_forward_span_ms: the device extent of the ``g.forward`` span (the
generator's forward: mapping and both towers), in ms; mean over the traced
batches."""

from gpu_bench import spans


def read(run):
    return spans.mean_extent(run, "g.forward")
