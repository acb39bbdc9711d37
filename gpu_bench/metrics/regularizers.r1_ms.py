"""regularizers.r1_ms: the R1 update (``r1_update``), the card synchronised at
both ends (traced run only); mean over the traced cycle."""

from gpu_bench import readers


def read(run):
    return readers.span_ms(run, "r1_s")
