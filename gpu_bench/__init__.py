"""The benchmark of the PyTorch/CUDA port (``multi_stylegan_torch``).

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cells and metrics in ``BENCHMARK.json``,
a configuration in ``configs/<config>.json``, a traffic mix in
``traffic/<traffic>.json`` (it names its driver, ``drivers/<driver>.py``),
a per-layer metric's reader in ``metrics/<metric>.py``.  ``reference/`` is
the plain PyTorch model math that decides ``correct``; it imports nothing of
the port.
"""
