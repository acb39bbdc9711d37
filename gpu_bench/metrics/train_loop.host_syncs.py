"""train_loop.host_syncs: the blocking runtime calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous
``cudaMemcpy``, ``cudaFree``) inside a main iteration's ``train.step`` host
span; mean over the traced cycle's main iterations."""

from gpu_bench import spans


def read(run):
    return spans.per_main_count(run, spans.Window.host_syncs)
