"""Frechet distance between activation statistics (the JAX package's
eval/frechet.py; reference multi_stylegan/validation_metrics.py:191-219,
400-428): numpy mean and covariance, ``scipy.linalg.sqrtm`` on the host,
the imaginary part dropped."""

from __future__ import annotations

import numpy as np


def frechet_distance(real_activations: np.ndarray, fake_activations: np.ndarray) -> float:
    from scipy.linalg import sqrtm

    real_mu = np.mean(real_activations, axis=0)
    real_cov = np.cov(real_activations, rowvar=False)
    fake_mu = np.mean(fake_activations, axis=0)
    fake_cov = np.cov(fake_activations, rowvar=False)
    if real_mu.shape != fake_mu.shape:
        raise ValueError(f"feature widths differ: {real_mu.shape} vs {fake_mu.shape}")
    diff = real_mu - fake_mu
    # no ``disp=``: newer scipy dropped it; the default returns the root alone
    cov_mean = sqrtm(real_cov @ fake_cov)
    if np.iscomplexobj(cov_mean):
        cov_mean = cov_mean.real
    return float(diff @ diff + np.trace(real_cov) + np.trace(fake_cov) - 2 * np.trace(cov_mean))
