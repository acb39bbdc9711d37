"""Frechet distance between activation statistics (the JAX package's
eval/frechet.py; reference multi_stylegan/validation_metrics.py:191-219,
400-428): numpy mean and covariance, ``scipy.linalg.sqrtm`` on the host,
the imaginary part dropped.  :func:`frechet_distance_device` takes the
square root by Newton-Schulz iteration on the activations' device instead;
the metrics keep the host path, as the JAX metrics do."""

from __future__ import annotations

import numpy as np
import torch


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


def frechet_distance_device(real_activations, fake_activations, n_iters: int = 30) -> float:
    """The Frechet distance with trace(sqrtm(C_real C_fake)) from
    ``n_iters`` normalised Newton-Schulz iterations in f32, on the device of
    the inputs (tensors; arrays go to the CPU), as the JAX function computes
    it (eval/frechet.py:36-59).  Its matrix products run at the matmul
    precision the caller set (``utils/precision.py::pin_f32`` keeps TF32
    off)."""
    ra = torch.as_tensor(real_activations).float()
    fa = torch.as_tensor(fake_activations).float().to(ra.device)
    mu_r, mu_f = ra.mean(0), fa.mean(0)
    cr, cf = torch.cov(ra.T), torch.cov(fa.T)
    diff = mu_r - mu_f
    m = cr @ cf
    # Newton-Schulz: normalise, iterate Y / Z, sqrt(M) = Y * sqrt(||M||)
    norm = torch.sqrt((m * m).sum())
    y = m / norm
    eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
    z = eye
    for _ in range(n_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    sqrt_m = y * torch.sqrt(norm)
    return float(diff @ diff + torch.trace(cr) + torch.trace(cf) - 2.0 * torch.trace(sqrt_m))
