"""models.g_forward_span_ms.sg2f1024: the device extent of the ``g.forward``
span (StyleGAN2's forward: the mapping and the one tower), in ms; mean over
the traced batches."""

from gpu_bench import spans


def read(run):
    return spans.mean_extent(run, "g.forward")
