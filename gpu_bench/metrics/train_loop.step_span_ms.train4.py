"""train_loop.step_span_ms.train4: the device extent on rank 0 of the
program's ``train.step`` span, in ms; mean over the traced cycle's main
iterations.  Read inside rank 0, where the spans live."""


def read(run):
    return run["readings"].get("step_span_ms")
