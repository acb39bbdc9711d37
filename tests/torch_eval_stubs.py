"""Cheap stand-ins for the evaluation's feature nets and its host Frechet
distance, for tests of the port's run-scale tools (tools/validation_run.py,
tools/soak_b24.py) on the CPU.

Those tests hold the plumbing (records, walls, resume), not the
nets: ``tests/test_torch_port_eval.py`` holds Inception-v3, I3D and FID /
FVD / IS against the JAX package.  At those tests' sizes here the real nets
take ~2 s a batch on one thread and scipy's ``sqrtm`` of a 2048 x 2048
product ~20 s a call.  The stand-ins keep the nets' input and output
shapes; the Frechet distance is the exact low-rank form of
``test_torch_port_eval.py::_frechet_low_rank``.

:func:`install` swaps them into ``multi_stylegan_torch.eval.metrics``.  A
launcher script that calls it at its top level gives them to the processes
it spawns too (a spawned child re-imports its parent's main module).
"""

import numpy as np
import torch
import torch.nn.functional as F


class _PooledProjection(torch.nn.Module):
    """A 4 x 4 mean pool of every channel (and frame), then a fixed random
    projection to ``dims``; ``classes`` logits beside it."""

    def __init__(self, in_dims: int, dims: int, classes: int = 0) -> None:
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.features = torch.nn.Parameter(torch.randn(in_dims, dims, generator=gen))
        self.logits = torch.nn.Parameter(torch.randn(dims, max(classes, 1), generator=gen) / 40)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        pooled = F.adaptive_avg_pool2d(x.flatten(1, -3), 4).flatten(1)
        feats = pooled @ self.features
        return feats if features_only else feats @ self.logits


def InceptionV3():  # noqa: N802 - stands in for the class of that name
    return _PooledProjection(3 * 16, 2048, classes=1000)


def InceptionI3D():  # noqa: N802 - stands in for the class of that name
    return _PooledProjection(3 * 3 * 16, 1024)


def frechet_low_rank(a, b):
    """The Frechet distance through sample space: with centred rows X_a,
    X_b, tr sqrtm(C_a C_b) is the sum of the singular values of
    X_a X_b^T / sqrt((n_a - 1)(n_b - 1))."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    xa, xb = a - a.mean(0), b - b.mean(0)
    na, nb = len(a) - 1, len(b) - 1
    diff = a.mean(0) - b.mean(0)
    cross = np.linalg.svd(xa @ xb.T, compute_uv=False).sum() / np.sqrt(na * nb)
    return float(diff @ diff + (xa * xa).sum() / na + (xb * xb).sum() / nb - 2 * cross)


def install(setattr_=setattr) -> None:
    """Swap the stand-ins into the metrics module (``setattr_``: e.g. a
    pytest ``monkeypatch.setattr``, to undo it after the test)."""
    from multi_stylegan_torch.eval import metrics

    setattr_(metrics, "InceptionV3", InceptionV3)
    setattr_(metrics, "InceptionI3D", InceptionI3D)
    setattr_(metrics, "frechet_distance", frechet_low_rank)
