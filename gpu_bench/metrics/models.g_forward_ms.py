"""models.g_forward_ms: the generator's forward (mapping and both towers) on
the card, by CUDA events around the call and before the copy to the host,
mean over the traced batches."""


def read(run):
    return run["readings"].get("g_forward_ms")
