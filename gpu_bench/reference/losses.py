"""GAN losses and regularizers (reference multi_stylegan/loss.py; the JAX
package's train/losses.py).

R1 and path length take a forward closure; the caller differentiates the
returned penalty w.r.t. the parameters, so both run a double backward
(``create_graph=True``), as the reference does (loss.py:283-317, 353-395).

Every batch mean is a mean over the global batch under data parallelism
(parallel/mesh.py): its value is the global one on every rank and its
gradient that of this rank's rows, which the step's gradient sum over the
ranks completes.  Alone they are the plain means.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpu_bench.reference import single as mesh


def apply_pixel_weight(x: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` times a [H, W] pixel-weight map broadcast as [1, 1, 1, H, W]
    (loss.py:124-128); ``x`` itself without one."""
    return x if weight is None else x * weight.reshape(1, 1, 1, *weight.shape[-2:])


def non_saturating_discriminator_loss(prediction_real: torch.Tensor,
                                      prediction_fake: torch.Tensor,
                                      weight: Optional[torch.Tensor] = None):
    """(mean softplus(-real), mean softplus(fake)), each optionally weighted
    per pixel (loss.py:134-170)."""
    return mesh.global_mean(apply_pixel_weight(F.softplus(-prediction_real), weight),
                            apply_pixel_weight(F.softplus(prediction_fake), weight))


def non_saturating_discriminator_loss_cut_mix(prediction: torch.Tensor, label: torch.Tensor):
    """Per-pixel-labelled NS loss for cut-mix batches (loss.py:173-195)."""
    return mesh.global_mean(F.softplus(-prediction) * label,
                            F.softplus(prediction) * (1.0 - label))


def r1_penalty(d_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
               images: torch.Tensor, use_pixel_head: bool = True) -> torch.Tensor:
    """R1 = 0.5 * E[ || grad_x (D_scalar(x).sum() + D_pixel(x).sum()) ||^2 ],
    through both heads (loss.py:302-317); differentiable w.r.t. D's params."""
    x = images.detach().requires_grad_(True)
    scalar, pixel = d_fn(x)
    s = scalar.sum() + pixel.sum() if use_pixel_head else scalar.sum()
    (grad,) = torch.autograd.grad(s, x, create_graph=True)
    return 0.5 * mesh.global_mean(grad.flatten(1).square().sum(dim=1))


def path_length_grads(synth_fn: Callable[[torch.Tensor], torch.Tensor],
                      wplus: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """grad_w (G(w) . y) with y = probe / sqrt(T*H*W), ``probe`` ~ N(0, 1) of
    the image's shape (multi_stylegan_generator.py:192-200); differentiable
    again w.r.t. the generator's params."""
    t, h, w = probe.shape[2], probe.shape[3], probe.shape[4]
    noise = probe / math.sqrt(t * h * w)
    (grad,) = torch.autograd.grad((synth_fn(wplus) * noise).sum(), wplus, create_graph=True)
    return grad


def per_sample_path_lengths(grads: torch.Tensor) -> torch.Tensor:
    """[B] path lengths sqrt(mean over the w+ slots of ||grad||^2 + 1e-8)."""
    return torch.sqrt(grads.square().sum(dim=2).mean(dim=1) + 1e-8)


def path_length_penalty(grads: torch.Tensor, mean_path_length: torch.Tensor,
                        decay: float = 0.01):
    """Penalty against a decayed running mean (loss.py:378-395): the mean
    enters through its updated value, which depends on the new path lengths,
    so the gradient carries the factor (1 - decay).

    Returns (penalty, path length, new running mean, detached)."""
    pl = mesh.global_mean(per_sample_path_lengths(grads))
    mean_detached = mean_path_length.detach()
    new_mean = mean_detached + decay * (pl - mean_detached)
    return (pl - new_mean).square(), pl, new_mean.detach()


def top_k_v(iteration: int, starting_iteration: int, final_iteration: int) -> float:
    """Keep-fraction schedule: 1.0 until start, linear to 0.5 at finish
    (loss.py:417-430), in f32 as the JAX package computes it.  ``iteration``
    is the 1-based step counter."""
    frac = np.float32(iteration - starting_iteration) / np.float32(
        max(1, final_iteration - starting_iteration))
    v = np.float32(0.5) * (np.float32(1.0) - frac) + np.float32(0.5)
    if iteration <= starting_iteration:
        v = np.float32(1.0)
    if iteration >= final_iteration:
        v = np.float32(0.5)
    return float(v)


def top_k_mask(prediction: torch.Tensor, v: float):
    """{0, 1} mask with exactly k = max(1, floor(B * v)) ones on the largest
    predictions (loss.py:432-444), ties broken by index, and k as a float.
    The reference gathers with torch.topk; masked means with the same k
    denominator are the same numbers.  Under data parallelism B and the
    order are the global batch's (its predictions gathered, ties broken by
    global index) and the mask is this rank's rows of the global one."""
    flat = mesh.gather_rows(prediction.detach()).reshape(-1)
    n = flat.shape[0]
    k = max(1, int(np.float32(n) * np.float32(v)))
    order = torch.argsort(-flat, stable=True)
    mask = torch.zeros_like(flat)
    mask[order[:k]] = 1.0
    return mesh.shard(mask.reshape(n, *prediction.shape[1:])), float(k)
