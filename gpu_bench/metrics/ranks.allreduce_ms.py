"""ranks.allreduce_ms: the device extents on rank 0 of the gradient
all-reduces (the ``ranks.all_reduce`` spans of ``parallel/mesh.py``'s
``all_reduce_grads``: the NCCL kernel, waiting for the other ranks
included), summed over a main iteration, in ms; mean over the traced
cycle's main iterations.  Read inside rank 0, where the spans live."""


def read(run):
    return run["readings"].get("allreduce_ms")
