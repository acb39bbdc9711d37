"""The tiny configuration the CPU tests run the harness at."""

import torch

TINY = {"generator": {"channels": [32, 32, 32, 32], "latent_dimensions": 32,
                      "depth_style_mapping": 2},
        "discriminator": {"encoder_channels": [[3, 16], [16, 24], [24, 32], [32, 48]],
                          "decoder_channels": [[48, 32], [32, 24], [24, 16]]}}
TRAFFIC = {"train": {"batch": 4, "real_batches": 3}, "sample": {"batch": 2, "trace_batches": 3}}


def overrides(cell_name: str) -> dict:
    kind = "train" if cell_name.startswith("train") else "sample"
    return dict(TINY, traffic=dict(TRAFFIC[kind]))


def context(cell_name: str, seed: int = 5, seconds: float = 0.0, trace: bool = False):
    from gpu_bench import bench, run

    cell = bench.find_cell(cell_name)
    kw = overrides(cell_name)
    cell.traffic.update(kw.pop("traffic"))
    return run.Context(cell, seed, seconds, trace, torch.device("cpu"),
                       bench.OUT / "tests" / cell_name, kw)
